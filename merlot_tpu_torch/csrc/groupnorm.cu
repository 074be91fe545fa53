// Fused GroupNorm(+residual+ReLU) for Hopper (sm_90a), plain C interface.
//
// Replaces merlot_tpu/ops/pallas_groupnorm.py `_gn_pallas` / `_gn_kernel`
// (the Pallas TPU kernel, K4). It computes the same function over one
// channels-last [HW, C] slab per image, C channels in G groups (channel c in
// group c / (C/G), so a group's channels are adjacent):
//   s1[c], s2[c] = fp32 sums of x and x^2 over HW
//   mean_g = (sum of s1 over the group) / n,  n = HW * C/G
//   var_g  = (sum of s2 over the group) / n - mean_g^2      (one pass)
//   rstd_g = rsqrt(var_g + eps)
//   out    = T((x - mean_g) * rstd_g * gamma + beta)        fp32, then T
//   out    = T(out + residual)                              if a residual
//   out    = max(out, 0)                                    if relu
// and writes mean_g and rstd_g [B, G] fp32 for the saved-stats backward.
// The fp32 steps are the plain version's (norms.group_norm_act_plain), one
// rounding each, written with the _rn intrinsics so that nvcc contracts
// none of them into an FMA; only the order of the sums differs.
//
// Design: one launch per call, one thread-block cluster per image. The
// launch plan (cuda_groupnorm.launch_plan, a function of the shape alone)
// picks the cluster size CS (1-16, a power of two) and the rows each block
// keeps resident; the image's HW rows are cut into CS contiguous ranges,
// one per block (its cluster rank). Each block:
//   1. copies the first `res_rows` rows of its range (a contiguous byte
//      range of the channels-last slab) into shared memory with bulk copies
//      (cp.async.bulk, four pieces on four mbarriers, issued by one thread),
//      and sums x and x^2 per channel over its rows as the pieces land; rows
//      past res_rows (only where a slab outgrows 16 blocks' shared memory:
//      the zero-shot stem) are read from global memory;
//   2. reduces its threads' sums in a fixed order to per-channel partials
//      and folds those into per-group partials in shared memory; after a
//      cluster barrier every block reads all the blocks' group partials
//      through distributed shared memory (all its loads issued together,
//      then summed in rank order) into the groups' mean and rstd (every
//      block the same bits; rank 0 writes them out);
//   3. normalizes its resident rows from shared memory (the rest from global
//      memory, which the few clusters in flight keep in the 50 MB L2), adds
//      the residual, applies the ReLU and writes; a last cluster barrier
//      keeps each block's partials alive until its cluster has read them.
// Deterministic, no atomics. Blocks stay at or under 113 KB of shared
// memory so that two fit on an SM, and one block's copy overlaps another's
// normalize. A cluster of more than 8 blocks is non-portable: its launch
// sets cudaFuncAttributeNonPortableClusterSizeAllowed, and the wrapper
// checks cudaOccupancyMaxActiveClusters (merlot_group_norm_max_clusters)
// before it first launches a plan.
//
// What bounds it on the H100: bytes. x is read once from device memory
// (again only for the rows past res_rows), the residual once, the output
// written once. The first design ran three launches per call (stats,
// finalize, apply) and read x twice from device memory.
//
// K4B, the backward (merlot_group_norm_act_bwd). It replaces no TPU kernel:
// the JAX package's backward (pallas_groupnorm.py `_gn_act_bwd`) is XLA
// math, which XLA fuses on the TPU; unfused on the H100 it is ~25 ATen
// launches a call, each a pass over fp32 intermediates. Per image, from K4's
// saved statistics and (with the ReLU) its output:
//   dyg    = relu ? (out > 0 ? dy : 0) : dy
//   x_hat  = (x - mean_g) * rstd_g
//   S1[c]  = sum over HW of dyg,  S2[c] = sum over HW of dyg * x_hat
//   m1_g   = (sum over the group of gamma[c] * S1[c]) / n
//   m2_g   = (sum over the group of gamma[c] * S2[c]) / n
//   dx     = T(rstd_g * ((dyg * gamma - m1_g) - x_hat * m2_g))
//   dres   = dyg                                     if a residual and relu
//   dbeta  = sum over B of S1,  dgamma = sum over B of S2        (fp32)
// The fp32 steps are norms.group_norm_act_bwd's, one rounding each (the _rn
// intrinsics); only the order of the sums differs, gamma factored out of
// the group sums included.
//
// Design: K4's plan over two slabs (x and dy) in place of one, a function of
// the shape alone (cuda_groupnorm.launch_plan with slabs=2): one cluster
// per image, CS contiguous row ranges. Each block:
//   1. bulk-copies the first res_rows rows of its x and dy (both pieces on
//      one mbarrier) and, as they land, sums dyg and dyg * x_hat per
//      channel; the saved output is read once from global memory for the
//      mask, and dyg written back over dy in shared memory; rows past
//      res_rows are read from global memory;
//   2. reduces its threads' sums to per-channel partials; after a cluster
//      barrier rank k sums the cluster's partials of its slice of channels
//      (ranks in order, through distributed shared memory), writes them to
//      a [2, B, C] fp32 scratch and folds gamma * S over its slice into
//      per-group partials; after a second barrier every block sums the
//      ranks' group partials in rank order into m1 and m2 (every block the
//      same bits);
//   3. writes dx (and dres) from its resident rows, reading the rest again
//      from global memory (the 50 MB L2 holds most of the clusters in
//      flight); a last cluster barrier keeps its partials alive.
// A second launch (gn_bwd_params_kernel) sums the scratch over B, images
// in order, into dbeta and dgamma. Deterministic, no atomics.
//
// What bounds K4B: bytes. x, dy and (with the ReLU) out are read once from
// device memory (again for the rows past res_rows), dx and dres written
// once; the scratch is 8 B C bytes each way.

#include <cooperative_groups.h>

#include "attention_common.cuh"
#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace merlot;

constexpr int kMaxThreads = 256;
constexpr int kPieces = 4;        // bulk copies (and mbarriers) per block
constexpr int kMaxCluster = 16;
constexpr int kBatch = 4;         // rows whose loads a thread keeps in flight

// 16 bytes of T: 8 bf16 or 4 fp32
template <typename T>
struct Vec;
template <>
struct Vec<bf16> {
  static constexpr int N = 8;
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
};

__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

// values already representable in T (rounded by round_to), so the
// conversion is exact
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float round_to(float x, bf16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_to(float x, float*) { return x; }

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) & ~(size_t)15; }

__host__ __device__ inline int threads_for(int V) { return V * (kMaxThreads / V); }

// shared memory of a block: resident rows (of x; K4B: of x, then of dy),
// the [R][C] thread sums (K4: x and x^2; K4B: dyg and dyg * x_hat), the
// per-channel and per-group partials, the group stats, the mbarriers
struct Layout {
  size_t slab, sums, part, gpart, stats, bars, total;
};

__host__ __device__ inline Layout layout(int res_rows, int C, int G, int elem,
                                         int slabs = 1) {
  const int V = C / (16 / elem), R = threads_for(V) / V;
  Layout l;
  l.slab = 0;
  l.sums = round16((size_t)slabs * res_rows * C * elem);
  l.part = l.sums + round16(2 * (size_t)R * C * sizeof(float));
  l.gpart = l.part + round16(2 * (size_t)C * sizeof(float));
  l.stats = l.gpart + round16(2 * (size_t)G * sizeof(float));
  l.bars = l.stats + round16(2 * (size_t)G * sizeof(float));
  l.total = l.bars + kPieces * sizeof(uint64_t);
  return l;
}

// thread layout: V = C/N vectors per row, threadIdx.x % V is the thread's
// column vector and threadIdx.x / V its row in a step of R rows
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
    gn_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, const T* __restrict__ res,
              T* __restrict__ out, float* __restrict__ mean_out,
              float* __restrict__ rstd_out, int HW, int C, int G, int rows_per_block,
              int res_rows, int relu, float eps) {
  constexpr int N = Vec<T>::N;
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout l = layout(res_rows, C, G, (int)sizeof(T));
  T* slab = reinterpret_cast<T*>(smem + l.slab);
  float* sums = reinterpret_cast<float*>(smem + l.sums);  // [2][R][C]
  float* part = reinterpret_cast<float*>(smem + l.part);  // [2][C]
  float* gpart = reinterpret_cast<float*>(smem + l.gpart);  // [2][G]
  float* gstat = reinterpret_cast<float*>(smem + l.stats);  // [2][G]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + l.bars);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cs = (int)cluster.num_blocks();
  const int b = blockIdx.y, tid = threadIdx.x;
  const int V = C / N, R = blockDim.x / V;
  const int cv = tid % V, r0 = tid / V;
  const int row0 = rank * rows_per_block;
  const int n_rows = max(0, min(HW, row0 + rows_per_block) - row0);
  const int n_res = min(n_rows, res_rows);
  const int piece = (n_res + kPieces - 1) / kPieces;
  const size_t base = ((size_t)b * HW + row0) * C;
  const T* xb = x + base;

  // 1. the resident rows arrive in pieces; sums of x and x^2 per channel
  if (tid == 0) {
    for (int p = 0; p < kPieces; ++p) sm90::mbar_init(&bar[p], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int p = 0; p < kPieces; ++p) {
      const int a = p * piece, e = min(n_res, a + piece);
      if (a >= e) break;
      const uint32_t bytes = (uint32_t)((size_t)(e - a) * C * sizeof(T));
      sm90::mbar_expect_tx(&bar[p], bytes);
      sm90::bulk_load(slab + (size_t)a * C, xb + (size_t)a * C, bytes, &bar[p]);
    }
  }
  float s1[N], s2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s1[i] = s2[i] = 0.f;
  if (r0 < R) {
    for (int p = 0; p < kPieces; ++p) {
      const int a = p * piece, e = min(n_res, a + piece);
      if (a >= e) break;
      sm90::mbar_wait(&bar[p], 0);
#pragma unroll 4
      for (int r = a + r0; r < e; r += R) {
        float v[N];
        load_vec(slab + (size_t)r * C + cv * N, v);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          s1[i] += v[i];
          s2[i] += v[i] * v[i];
        }
      }
    }
    // streamed rows: kBatch loads in flight, then summed in row order
    for (int r = n_res + r0; r < n_rows; r += kBatch * R) {
      float v[kBatch][N];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (r + u * R < n_rows) load_vec(xb + (size_t)(r + u * R) * C + cv * N, v[u]);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (r + u * R >= n_rows) break;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          s1[i] += v[u][i];
          s2[i] += v[u][i] * v[u][i];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      sums[r0 * C + cv * N + i] = s1[i];
      sums[(R + r0) * C + cv * N + i] = s2[i];
    }
  }
  __syncthreads();
  // 2. the block's channel partials (its row steps in order)
  for (int c = tid; c < C; c += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int r = 0; r < R; ++r) {
      a += sums[r * C + c];
      q += sums[(R + r) * C + c];
    }
    part[c] = a;
    part[C + c] = q;
  }
  __syncthreads();
  // the block's group partials (its channels in order), then the cluster's
  // (the ranks in order, their loads issued together)
  const int cpg = C / G;
  for (int g = tid; g < G; g += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int j = 0; j < cpg; ++j) {
      a += part[g * cpg + j];
      q += part[C + g * cpg + j];
    }
    gpart[g] = a;
    gpart[G + g] = q;
  }
  sm90::cluster_arrive();
  sm90::cluster_wait();
  const float n = (float)HW * (float)cpg;
  for (int g = tid; g < G; g += blockDim.x) {
    float va[kMaxCluster], vq[kMaxCluster];
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      if (k < cs) {
        const float* p = cluster.map_shared_rank(gpart, k);
        va[k] = p[g];
        vq[k] = p[G + g];
      }
    }
    float a = 0.f, q = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      if (k < cs) {
        a += va[k];
        q += vq[k];
      }
    }
    const float mean = __fdiv_rn(a, n);
    const float var = __fsub_rn(__fdiv_rn(q, n), __fmul_rn(mean, mean));
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    gstat[g] = mean;
    gstat[G + g] = rstd;
    if (rank == 0) {
      mean_out[b * G + g] = mean;
      rstd_out[b * G + g] = rstd;
    }
  }
  sm90::cluster_arrive();  // this block is done reading the others' partials
  __syncthreads();

  // 3. normalize, residual, ReLU
  if (r0 < R) {
    float m[N], rs[N], ga[N], be[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = cv * N + i;
      m[i] = gstat[c / cpg];
      rs[i] = gstat[G + c / cpg];
      ga[i] = gamma[c];
      be[i] = beta[c];
    }
    // kBatch rows per step: their loads (the residual's from device
    // memory) in flight together, then normalized and stored
    for (int r = r0; r < n_rows; r += kBatch * R) {
      float v[kBatch][N], rv[kBatch][N];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int row = r + u * R;
        if (row >= n_rows) break;
        const size_t at = (size_t)row * C + cv * N;
        if (row < n_res)
          load_vec(slab + at, v[u]);
        else
          load_vec(xb + at, v[u]);
        if (res != nullptr) load_vec(res + base + at, rv[u]);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int row = r + u * R;
        if (row >= n_rows) break;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float xn = __fmul_rn(__fsub_rn(v[u][i], m[i]), rs[i]);
          float o = round_to(__fadd_rn(__fmul_rn(xn, ga[i]), be[i]), (T*)nullptr);
          if (res != nullptr) o = round_to(__fadd_rn(o, rv[u][i]), (T*)nullptr);
          if (relu) o = fmaxf(o, 0.f);
          v[u][i] = o;
        }
        store_vec(out + base + (size_t)row * C + cv * N, v[u]);
      }
    }
  }
  sm90::cluster_wait();  // the cluster is done with this block's partials
}

// ---------------------------------------------------------------------------
// K4B

constexpr int kBatchB = 2;  // rows whose loads a K4B thread keeps in flight

__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

// dy under the ReLU's mask: 0 where the saved output is not > 0
template <int N>
__device__ __forceinline__ void mask_dy(float (&d)[N], const uint4& o) {
  float ov[N];
  unpack(o, ov);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (!(ov[i] > 0.f)) d[i] = 0.f;
}

// one row vector's terms of S1 (dyg) and S2 (dyg * x_hat)
template <int N>
__device__ __forceinline__ void accumulate(float (&s1)[N], float (&s2)[N], const float (&xv)[N],
                                           const float (&d)[N], const float (&mu)[N],
                                           const float (&rs)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float xh = __fmul_rn(__fsub_rn(xv[i], mu[i]), rs[i]);
    s1[i] = __fadd_rn(s1[i], d[i]);
    s2[i] = __fadd_rn(s2[i], __fmul_rn(d[i], xh));
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
    gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const T* __restrict__ out, const float* __restrict__ gamma,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  T* __restrict__ dx, T* __restrict__ dres, float* __restrict__ scratch,
                  int B, int HW, int C, int G, int rows_per_block, int res_rows) {
  constexpr int N = Vec<T>::N;
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout l = layout(res_rows, C, G, (int)sizeof(T), 2);
  T* xs = reinterpret_cast<T*>(smem + l.slab);
  T* ds = xs + (size_t)res_rows * C;
  float* sums = reinterpret_cast<float*>(smem + l.sums);    // [2][R][C], then [2][C]
  float* part = reinterpret_cast<float*>(smem + l.part);    // [2][C]
  float* gpart = reinterpret_cast<float*>(smem + l.gpart);  // [2][G]
  float* gstat = reinterpret_cast<float*>(smem + l.stats);  // [2][G]: m1, m2
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + l.bars);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cs = (int)cluster.num_blocks();
  const int b = blockIdx.y, tid = threadIdx.x;
  const int V = C / N, R = blockDim.x / V;
  const int cv = tid % V, r0 = tid / V;
  const int cpg = C / G;
  const int row0 = rank * rows_per_block;
  const int n_rows = max(0, min(HW, row0 + rows_per_block) - row0);
  const int n_res = min(n_rows, res_rows);
  const int piece = (n_res + kPieces - 1) / kPieces;
  const size_t base = ((size_t)b * HW + row0) * C;
  const T* xb = x + base;
  const T* db = dy + base;
  const T* ob = out == nullptr ? nullptr : out + base;

  // 1. the resident rows of x and dy arrive in pieces; S1 and S2 per channel
  if (tid == 0) {
    for (int p = 0; p < kPieces; ++p) sm90::mbar_init(&bar[p], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int p = 0; p < kPieces; ++p) {
      const int a = p * piece, e = min(n_res, a + piece);
      if (a >= e) break;
      const uint32_t bytes = (uint32_t)((size_t)(e - a) * C * sizeof(T));
      sm90::mbar_expect_tx(&bar[p], 2 * bytes);
      sm90::bulk_load(xs + (size_t)a * C, xb + (size_t)a * C, bytes, &bar[p]);
      sm90::bulk_load(ds + (size_t)a * C, db + (size_t)a * C, bytes, &bar[p]);
    }
  }
  float mu[N], rs[N], s1[N], s2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int g = (cv * N + i) / cpg;
    mu[i] = mean[b * G + g];
    rs[i] = rstd[b * G + g];
    s1[i] = s2[i] = 0.f;
  }
  if (r0 < R) {
    for (int p = 0; p < kPieces; ++p) {
      const int a = p * piece, e = min(n_res, a + piece);
      if (a >= e) break;
      sm90::mbar_wait(&bar[p], 0);
      for (int r = a + r0; r < e; r += kBatchB * R) {
        uint4 o[kBatchB];
        if (ob != nullptr) {
#pragma unroll
          for (int u = 0; u < kBatchB; ++u)
            if (r + u * R < e) o[u] = ld16(ob + (size_t)(r + u * R) * C + cv * N);
        }
#pragma unroll
        for (int u = 0; u < kBatchB; ++u) {
          const int row = r + u * R;
          if (row >= e) break;
          const size_t at = (size_t)row * C + cv * N;
          float xv[N], d[N];
          unpack(ld16(xs + at), xv);
          unpack(ld16(ds + at), d);
          if (ob != nullptr) {
            mask_dy(d, o[u]);
            store_vec(ds + at, d);  // dyg, for the write pass
          }
          accumulate(s1, s2, xv, d, mu, rs);
        }
      }
    }
    // streamed rows: kBatchB rows' loads in flight, then summed in row order
    for (int r = n_res + r0; r < n_rows; r += kBatchB * R) {
      uint4 xr[kBatchB], dr[kBatchB], o[kBatchB];
#pragma unroll
      for (int u = 0; u < kBatchB; ++u) {
        if (r + u * R >= n_rows) break;
        const size_t at = (size_t)(r + u * R) * C + cv * N;
        xr[u] = ld16(xb + at);
        dr[u] = ld16(db + at);
        if (ob != nullptr) o[u] = ld16(ob + at);
      }
#pragma unroll
      for (int u = 0; u < kBatchB; ++u) {
        if (r + u * R >= n_rows) break;
        float xv[N], d[N];
        unpack(xr[u], xv);
        unpack(dr[u], d);
        if (ob != nullptr) mask_dy(d, o[u]);
        accumulate(s1, s2, xv, d, mu, rs);
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      sums[r0 * C + cv * N + i] = s1[i];
      sums[(R + r0) * C + cv * N + i] = s2[i];
    }
  }
  __syncthreads();
  // 2. the block's channel partials (its row steps in order)
  for (int c = tid; c < C; c += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int r = 0; r < R; ++r) {
      a += sums[r * C + c];
      q += sums[(R + r) * C + c];
    }
    part[c] = a;
    part[C + c] = q;
  }
  sm90::cluster_arrive();
  sm90::cluster_wait();
  // this rank's slice of channels: the cluster's partials, ranks in order
  // (their loads issued together), into the scratch and fin
  float* fin = sums;  // [2][C]; the thread sums are spent
  const int chunk = (C + cs - 1) / cs;
  const int lo = min(C, rank * chunk), hi = min(C, lo + chunk);
  for (int c = lo + tid; c < hi; c += blockDim.x) {
    float va[kMaxCluster], vq[kMaxCluster];
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      if (k < cs) {
        const float* p = cluster.map_shared_rank(part, k);
        va[k] = p[c];
        vq[k] = p[C + c];
      }
    }
    float a = 0.f, q = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      if (k < cs) {
        a += va[k];
        q += vq[k];
      }
    }
    fin[c] = a;
    fin[C + c] = q;
    scratch[(size_t)b * C + c] = a;
    scratch[((size_t)B + b) * C + c] = q;
  }
  __syncthreads();
  // the slice's gamma-weighted group partials (channels in order)
  for (int g = tid; g < G; g += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int c = max(lo, g * cpg); c < min(hi, (g + 1) * cpg); ++c) {
      a += __fmul_rn(gamma[c], fin[c]);
      q += __fmul_rn(gamma[c], fin[C + c]);
    }
    gpart[g] = a;
    gpart[G + g] = q;
  }
  sm90::cluster_arrive();
  sm90::cluster_wait();
  const float n = (float)HW * (float)cpg;
  for (int g = tid; g < G; g += blockDim.x) {
    float va[kMaxCluster], vq[kMaxCluster];
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      if (k < cs) {
        const float* p = cluster.map_shared_rank(gpart, k);
        va[k] = p[g];
        vq[k] = p[G + g];
      }
    }
    float a = 0.f, q = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      if (k < cs) {
        a += va[k];
        q += vq[k];
      }
    }
    gstat[g] = __fdiv_rn(a, n);
    gstat[G + g] = __fdiv_rn(q, n);
  }
  sm90::cluster_arrive();  // this block is done reading the others' partials
  __syncthreads();

  // 3. dx (and dres): kBatchB rows' loads in flight, then computed and stored
  if (r0 < R) {
    float ga[N], m1[N], m2[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = cv * N + i;
      ga[i] = gamma[c];
      m1[i] = gstat[c / cpg];
      m2[i] = gstat[G + c / cpg];
    }
    for (int r = r0; r < n_rows; r += kBatchB * R) {
      uint4 xr[kBatchB], dr[kBatchB], o[kBatchB];
#pragma unroll
      for (int u = 0; u < kBatchB; ++u) {
        const int row = r + u * R;
        if (row >= n_rows) break;
        const size_t at = (size_t)row * C + cv * N;
        if (row < n_res) {
          xr[u] = ld16(xs + at);
          dr[u] = ld16(ds + at);  // already dyg
        } else {
          xr[u] = ld16(xb + at);
          dr[u] = ld16(db + at);
          if (ob != nullptr) o[u] = ld16(ob + at);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatchB; ++u) {
        const int row = r + u * R;
        if (row >= n_rows) break;
        float xv[N], d[N], v[N];
        unpack(xr[u], xv);
        unpack(dr[u], d);
        if (ob != nullptr && row >= n_res) mask_dy(d, o[u]);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float xh = __fmul_rn(__fsub_rn(xv[i], mu[i]), rs[i]);
          const float t = __fsub_rn(__fmul_rn(d[i], ga[i]), m1[i]);
          v[i] = __fmul_rn(rs[i], __fsub_rn(t, __fmul_rn(xh, m2[i])));
        }
        const size_t at = base + (size_t)row * C + cv * N;
        store_vec(dx + at, v);
        if (dres != nullptr) store_vec(dres + at, d);
      }
    }
  }
  sm90::cluster_wait();  // the cluster is done with this block's partials
}

// dbeta[c] and dgamma[c]: the scratch's [2, B, C] sums over B, in order
__global__ void gn_bwd_params_kernel(const float* __restrict__ scratch,
                                     float* __restrict__ dgamma, float* __restrict__ dbeta,
                                     int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, q = 0.f;
#pragma unroll 8
  for (int b = 0; b < B; ++b) {
    a += scratch[(size_t)b * C + c];
    q += scratch[((size_t)B + b) * C + c];
  }
  dbeta[c] = a;
  dgamma[c] = q;
}

// ---------------------------------------------------------------------------
// launches

bool valid_plan(int B, int HW, int C, int G, int is_bf16, int cs, int rows_per_block,
                int res_rows, int slabs) {
  const int per_vec = is_bf16 ? 8 : 4;
  if (!(B > 0 && B <= 65535 && HW > 0 && C > 0 && G > 0 && C % G == 0 &&
        C % per_vec == 0 && C / per_vec <= kMaxThreads))
    return false;
  if (cs < 1 || cs > kMaxCluster || (cs & (cs - 1)) != 0 || rows_per_block <= 0 ||
      (long)cs * rows_per_block < HW || res_rows < 0 || res_rows > rows_per_block)
    return false;
  return layout(res_rows, C, G, is_bf16 ? 2 : 4, slabs).total <= kMaxSmem;
}

template <typename T>
cudaLaunchConfig_t config(int cs, int B, int C, size_t smem, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, B);
  cfg.blockDim = dim3(threads_for(C / Vec<T>::N));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename K>
cudaError_t set_attributes(K kernel, int cs, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cs > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <typename T>
cudaError_t run(const T* x, const float* gamma, const float* beta, const T* res, T* out,
                float* mean, float* rstd, int B, int HW, int C, int G, int cs,
                int rows_per_block, int res_rows, int relu, float eps, cudaStream_t st) {
  const size_t smem = layout(res_rows, C, G, (int)sizeof(T)).total;
  cudaError_t err = set_attributes(gn_kernel<T>, cs, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<T>(cs, B, C, smem, st, attr);
  err = cudaLaunchKernelEx(&cfg, gn_kernel<T>, x, gamma, beta, res, out, mean, rstd, HW,
                           C, G, rows_per_block, res_rows, relu, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_bwd(const T* x, const T* dy, const T* out, const float* gamma,
                    const float* mean, const float* rstd, T* dx, T* dres, float* scratch,
                    float* dgamma, float* dbeta, int B, int HW, int C, int G, int cs,
                    int rows_per_block, int res_rows, cudaStream_t st) {
  const size_t smem = layout(res_rows, C, G, (int)sizeof(T), 2).total;
  cudaError_t err = set_attributes(gn_bwd_kernel<T>, cs, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<T>(cs, B, C, smem, st, attr);
  err = cudaLaunchKernelEx(&cfg, gn_bwd_kernel<T>, x, dy, out, gamma, mean, rstd, dx, dres,
                           scratch, B, HW, C, G, rows_per_block, res_rows);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_params_kernel<<<(C + 127) / 128, 128, 0, st>>>(scratch, dgamma, dbeta, B, C);
  return cudaGetLastError();
}

template <typename T, typename K>
int max_clusters(K kernel, int C, int G, int cs, int res_rows, int slabs) {
  const size_t smem = layout(res_rows, C, G, (int)sizeof(T), slabs).total;
  if (set_attributes(kernel, cs, smem) != cudaSuccess) return -1;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<T>(cs, 1, C, smem, 0, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

}  // namespace

extern "C" {

// Shared memory of one block of a plan (res_rows resident rows of C
// channels in G groups; slabs = 1 for K4, 2 for K4B), or -1 for an invalid
// one (the launch plan's check)
long merlot_group_norm_smem(int res_rows, int C, int G, int is_bf16, int slabs) {
  if (res_rows < 0 || C <= 0 || G <= 0 || C % (is_bf16 ? 8 : 4) != 0 ||
      C / (is_bf16 ? 8 : 4) > kMaxThreads || slabs < 1 || slabs > 2)
    return -1;
  return (long)layout(res_rows, C, G, is_bf16 ? 2 : 4, slabs).total;
}

// Clusters of cs blocks of this plan the card can hold at once (0: the
// cluster cannot be scheduled), or -1 if the query failed; slabs = 1 asks
// of K4, 2 of K4B
int merlot_group_norm_max_clusters(int C, int G, int is_bf16, int cs, int res_rows,
                                   int slabs) {
  if (slabs == 2)
    return is_bf16 ? max_clusters<bf16>(gn_bwd_kernel<bf16>, C, G, cs, res_rows, 2)
                   : max_clusters<float>(gn_bwd_kernel<float>, C, G, cs, res_rows, 2);
  return is_bf16 ? max_clusters<bf16>(gn_kernel<bf16>, C, G, cs, res_rows, 1)
                 : max_clusters<float>(gn_kernel<float>, C, G, cs, res_rows, 1);
}

// x/residual/out: [B, HW, C] contiguous (channels-last), fp32 (is_bf16=0) or
// bf16 (is_bf16=1), 16-byte aligned; residual may be NULL. gamma/beta: [C]
// fp32. mean/rstd: [B, G] fp32 outputs. cs, rows_per_block, res_rows: the
// launch plan (cluster size, rows of HW per block, rows kept in shared
// memory). Launches on `stream` and returns a cudaError_t (0 on success).
int merlot_group_norm_act(const void* x, const void* gamma, const void* beta,
                          const void* residual, void* out, void* mean, void* rstd, int B,
                          int HW, int C, int G, int is_bf16, int relu, float eps, int cs,
                          int rows_per_block, int res_rows, void* stream) {
  if (!valid_plan(B, HW, C, G, is_bf16, cs, rows_per_block, res_rows, 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  if (is_bf16)
    return (int)run(static_cast<const bf16*>(x), g, bt, static_cast<const bf16*>(residual),
                    static_cast<bf16*>(out), m, r, B, HW, C, G, cs, rows_per_block,
                    res_rows, relu, eps, st);
  return (int)run(static_cast<const float*>(x), g, bt, static_cast<const float*>(residual),
                  static_cast<float*>(out), m, r, B, HW, C, G, cs, rows_per_block, res_rows,
                  relu, eps, st);
}

// K4B. x, dy: [B, HW, C] as for K4; out: K4's output, or NULL without the
// ReLU; gamma [C], mean/rstd [B, G] fp32 (K4's saved stats). Writes dx
// [B, HW, C] and, unless NULL, dres (dy under the ReLU's mask), both in x's
// type; scratch [2, B, C] fp32; dgamma, dbeta [C] fp32. cs, rows_per_block,
// res_rows: the launch plan with slabs=2. Two launches on `stream`; returns
// a cudaError_t (0 on success).
int merlot_group_norm_act_bwd(const void* x, const void* dy, const void* out,
                              const void* gamma, const void* mean, const void* rstd, void* dx,
                              void* dres, void* scratch, void* dgamma, void* dbeta, int B,
                              int HW, int C, int G, int is_bf16, int cs, int rows_per_block,
                              int res_rows, void* stream) {
  if (!valid_plan(B, HW, C, G, is_bf16, cs, rows_per_block, res_rows, 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* m = static_cast<const float*>(mean);
  const float* r = static_cast<const float*>(rstd);
  float* s = static_cast<float*>(scratch);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  if (is_bf16)
    return (int)run_bwd(static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
                        static_cast<const bf16*>(out), g, m, r, static_cast<bf16*>(dx),
                        static_cast<bf16*>(dres), s, dg, db, B, HW, C, G, cs,
                        rows_per_block, res_rows, st);
  return (int)run_bwd(static_cast<const float*>(x), static_cast<const float*>(dy),
                      static_cast<const float*>(out), g, m, r, static_cast<float*>(dx),
                      static_cast<float*>(dres), s, dg, db, B, HW, C, G, cs, rows_per_block,
                      res_rows, st);
}

}  // extern "C"
