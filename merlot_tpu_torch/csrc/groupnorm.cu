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

// shared memory of a block: resident rows, the [R][C] thread sums (x and
// x^2), the per-channel and per-group partials, the group stats, the
// mbarriers
struct Layout {
  size_t slab, sums, part, gpart, stats, bars, total;
};

__host__ __device__ inline Layout layout(int res_rows, int C, int G, int elem) {
  const int V = C / (16 / elem), R = threads_for(V) / V;
  Layout l;
  l.slab = 0;
  l.sums = round16((size_t)res_rows * C * elem);
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

bool valid_plan(int B, int HW, int C, int G, int is_bf16, int cs, int rows_per_block,
                int res_rows) {
  const int per_vec = is_bf16 ? 8 : 4;
  if (!(B > 0 && B <= 65535 && HW > 0 && C > 0 && G > 0 && C % G == 0 &&
        C % per_vec == 0 && C / per_vec <= kMaxThreads))
    return false;
  if (cs < 1 || cs > kMaxCluster || (cs & (cs - 1)) != 0 || rows_per_block <= 0 ||
      (long)cs * rows_per_block < HW || res_rows < 0 || res_rows > rows_per_block)
    return false;
  return layout(res_rows, C, G, is_bf16 ? 2 : 4).total <= kMaxSmem;
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

template <typename T>
cudaError_t set_attributes(int cs, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      gn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cs > 8)
    err = cudaFuncSetAttribute(gn_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <typename T>
cudaError_t run(const T* x, const float* gamma, const float* beta, const T* res, T* out,
                float* mean, float* rstd, int B, int HW, int C, int G, int cs,
                int rows_per_block, int res_rows, int relu, float eps, cudaStream_t st) {
  const size_t smem = layout(res_rows, C, G, (int)sizeof(T)).total;
  cudaError_t err = set_attributes<T>(cs, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<T>(cs, B, C, smem, st, attr);
  err = cudaLaunchKernelEx(&cfg, gn_kernel<T>, x, gamma, beta, res, out, mean, rstd, HW,
                           C, G, rows_per_block, res_rows, relu, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int max_clusters(int C, int G, int cs, int res_rows) {
  const size_t smem = layout(res_rows, C, G, (int)sizeof(T)).total;
  if (set_attributes<T>(cs, smem) != cudaSuccess) return -1;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<T>(cs, 1, C, smem, 0, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, gn_kernel<T>, &cfg) != cudaSuccess) return -1;
  return n;
}

}  // namespace

extern "C" {

// Shared memory of one block of a plan (res_rows resident rows of C
// channels in G groups), or -1 for an invalid one (the launch plan's check)
long merlot_group_norm_smem(int res_rows, int C, int G, int is_bf16) {
  if (res_rows < 0 || C <= 0 || G <= 0 || C % (is_bf16 ? 8 : 4) != 0 ||
      C / (is_bf16 ? 8 : 4) > kMaxThreads)
    return -1;
  return (long)layout(res_rows, C, G, is_bf16 ? 2 : 4).total;
}

// Clusters of cs blocks of this plan the card can hold at once (0: the
// cluster cannot be scheduled), or -1 if the query failed
int merlot_group_norm_max_clusters(int C, int G, int is_bf16, int cs, int res_rows) {
  return is_bf16 ? max_clusters<bf16>(C, G, cs, res_rows)
                 : max_clusters<float>(C, G, cs, res_rows);
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
  if (!valid_plan(B, HW, C, G, is_bf16, cs, rows_per_block, res_rows))
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

}  // extern "C"
