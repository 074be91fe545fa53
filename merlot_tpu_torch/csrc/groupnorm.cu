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
// Design. The TPU kernel runs one program per image, which would be 20 to
// 128 blocks here, and holds the whole slab (up to 2.2 MB) in VMEM. On the
// H100 three kernels do it instead, deterministic and without atomics:
//   1. stats, grid (HW chunk, image): each block reads its chunk of rows
//      (about 32 KB) once, one 16-byte vector per thread per row, each
//      thread at a fixed column; the rows a block covers meet in shared
//      memory in a fixed order, and the block writes per-channel fp32
//      partials s1, s2 [B, chunks, C];
//   2. finalize, one block per image: the partials summed over the chunks
//      in order and folded into groups give mean and rstd [B, G] (once per
//      image, rather than in every apply block, where at C = 1024 the
//      partials would be read 17 times over, 4x the chunk's own bytes);
//   3. apply, grid (HW chunk, image): normalizes its rows, adds the
//      residual, applies the ReLU and writes.
// One K4 call is these three launches.
//
// What bounds it on the H100: bytes. Each element is read twice, by the
// stats and the apply kernels (a slab is 0.1-2.2 MB per image, but the
// whole tensor, up to 277 MB at the train step's stem, is read between the
// two, so the second read comes from device memory), the residual once and
// the output written once, against a bound that reads x once. The operations
// per element are a handful of fp32 FMAs. A single pass that keeps small
// slabs in shared memory is the open speed work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxThreads = 256;
constexpr int kChunkBytes = 32768;  // rows per block: about this many bytes

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

// thread layout of both kernels: V = C/N vectors per row, threadIdx.x % V
// is the thread's column vector and threadIdx.x / V its row in a step of
// R = blockDim.x / V rows
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part1,
                    float* __restrict__ part2, int HW, int C, int chunk_rows) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float smem[];
  const int V = C / N, R = blockDim.x / V;
  const int cv = threadIdx.x % V, r0 = threadIdx.x / V;
  const int b = blockIdx.y, chunk = blockIdx.x, n_chunks = gridDim.x;
  const int row_end = min(HW, (chunk + 1) * chunk_rows);
  const T* xb = x + (size_t)b * HW * C + cv * N;

  float s1[N], s2[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s1[i] = s2[i] = 0.f;
#pragma unroll 4
  for (int r = chunk * chunk_rows + r0; r < row_end; r += R) {
    float v[N];
    load_vec(xb + (size_t)r * C, v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s1[i] += v[i];
      s2[i] += v[i] * v[i];
    }
  }
  float* sm1 = smem;              // [R][C]
  float* sm2 = smem + R * C;      // [R][C]
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sm1[r0 * C + cv * N + i] = s1[i];
    sm2[r0 * C + cv * N + i] = s2[i];
  }
  __syncthreads();
  const size_t base = ((size_t)b * n_chunks + chunk) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int r = 0; r < R; ++r) {
      a += sm1[r * C + c];
      q += sm2[r * C + c];
    }
    part1[base + c] = a;
    part2[base + c] = q;
  }
}

// one block per image: its channel sums over the chunks in order, folded
// into groups: mean, the one-pass variance, rstd
__global__ void __launch_bounds__(kMaxThreads)
    gn_finalize_kernel(const float* __restrict__ part1, const float* __restrict__ part2,
                       float* __restrict__ mean_out, float* __restrict__ rstd_out,
                       int HW, int C, int G, int n_chunks, float eps) {
  extern __shared__ float smem[];
  float* cs1 = smem;      // [C]
  float* cs2 = smem + C;  // [C]
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float* p1 = part1 + (size_t)b * n_chunks * C + c;
    const float* p2 = part2 + (size_t)b * n_chunks * C + c;
    float a = 0.f, q = 0.f;
    for (int k = 0; k < n_chunks; ++k) {
      a += p1[(size_t)k * C];
      q += p2[(size_t)k * C];
    }
    cs1[c] = a;
    cs2[c] = q;
  }
  __syncthreads();
  const int cpg = C / G;
  const float n = (float)HW * (float)cpg;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int j = 0; j < cpg; ++j) {
      a += cs1[g * cpg + j];
      q += cs2[g * cpg + j];
    }
    const float mean = __fdiv_rn(a, n);
    const float var = __fsub_rn(__fdiv_rn(q, n), __fmul_rn(mean, mean));
    mean_out[b * G + g] = mean;
    rstd_out[b * G + g] = rsqrtf(__fadd_rn(var, eps));
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const T* __restrict__ res,
                    T* __restrict__ out, const float* __restrict__ mean,
                    const float* __restrict__ rstd, int HW, int C, int G,
                    int chunk_rows, int relu) {
  constexpr int N = Vec<T>::N;
  const int V = C / N, R = blockDim.x / V;
  const int cv = threadIdx.x % V, r0 = threadIdx.x / V;
  const int b = blockIdx.y, chunk = blockIdx.x, cpg = C / G;
  float m[N], rs[N], ga[N], be[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = cv * N + i;
    m[i] = mean[b * G + c / cpg];
    rs[i] = rstd[b * G + c / cpg];
    ga[i] = gamma[c];
    be[i] = beta[c];
  }
  const size_t off = (size_t)b * HW * C + cv * N;
  const int row_end = min(HW, (chunk + 1) * chunk_rows);
#pragma unroll 2
  for (int r = chunk * chunk_rows + r0; r < row_end; r += R) {
    const size_t at = off + (size_t)r * C;
    float v[N];
    load_vec(x + at, v);
    float rv[N];
    if (res != nullptr) load_vec(res + at, rv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float xn = __fmul_rn(__fsub_rn(v[i], m[i]), rs[i]);
      float o = round_to(__fadd_rn(__fmul_rn(xn, ga[i]), be[i]), (T*)nullptr);
      if (res != nullptr) o = round_to(__fadd_rn(o, rv[i]), (T*)nullptr);
      if (relu) o = fmaxf(o, 0.f);
      v[i] = o;
    }
    store_vec(out + at, v);
  }
}

// rows per chunk: about kChunkBytes, a whole number of row steps
int chunk_rows_for(int C, int elem, int R) {
  int rows = kChunkBytes / (C * elem);
  rows = rows < R ? R : rows - rows % R;
  return rows;
}

int threads_for(int V) { return V * (kMaxThreads / V); }

template <typename T>
cudaError_t run(const T* x, const float* gamma, const float* beta, const T* res,
                T* out, float* mean, float* rstd, float* part, int B, int HW, int C,
                int G, int relu, float eps, cudaStream_t st) {
  const int V = C / Vec<T>::N;
  const int threads = threads_for(V), R = threads / V;
  const int rows = chunk_rows_for(C, (int)sizeof(T), R);
  const int n_chunks = (HW + rows - 1) / rows;
  float* part1 = part;
  float* part2 = part + (size_t)B * n_chunks * C;
  const dim3 grid(n_chunks, B);
  gn_stats_kernel<T><<<grid, threads, 2 * (size_t)R * C * sizeof(float), st>>>(
      x, part1, part2, HW, C, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_finalize_kernel<<<B, kMaxThreads, 2 * (size_t)C * sizeof(float), st>>>(
      part1, part2, mean, rstd, HW, C, G, n_chunks, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply_kernel<T><<<grid, threads, 0, st>>>(x, gamma, beta, res, out, mean, rstd,
                                                HW, C, G, rows, relu);
  return cudaGetLastError();
}

bool valid_shape(int B, int HW, int C, int G, int is_bf16) {
  const int per_vec = is_bf16 ? 8 : 4;
  return B > 0 && B <= 65535 && HW > 0 && C > 0 && G > 0 && C % G == 0 &&
         C % per_vec == 0 && C / per_vec <= kMaxThreads;
}

}  // namespace

extern "C" {

// fp32 floats of workspace `merlot_group_norm_act` needs for these shapes
// (the per-chunk channel partials s1 and s2), or -1 for a shape it refuses
long merlot_group_norm_workspace(int B, int HW, int C, int is_bf16) {
  if (!valid_shape(B, HW, C, 1, is_bf16)) return -1;
  const int V = C / (is_bf16 ? 8 : 4);
  const int R = threads_for(V) / V;
  const int rows = chunk_rows_for(C, is_bf16 ? 2 : 4, R);
  const long n_chunks = (HW + rows - 1) / rows;
  return 2L * B * n_chunks * C;
}

// x/residual/out: [B, HW, C] contiguous (channels-last), fp32 (is_bf16=0) or
// bf16 (is_bf16=1), 16-byte aligned; residual may be NULL. gamma/beta: [C]
// fp32. mean/rstd: [B, G] fp32 outputs. part: workspace of
// merlot_group_norm_workspace(B, HW, C, is_bf16) floats. Launches on
// `stream` and returns a cudaError_t (0 on success).
int merlot_group_norm_act(const void* x, const void* gamma, const void* beta,
                          const void* residual, void* out, void* mean, void* rstd,
                          void* part, int B, int HW, int C, int G, int is_bf16,
                          int relu, float eps, void* stream) {
  if (!valid_shape(B, HW, C, G, is_bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  float* p = static_cast<float*>(part);
  if (is_bf16)
    return (int)run(static_cast<const bf16*>(x), g, bt, static_cast<const bf16*>(residual),
                    static_cast<bf16*>(out), m, r, p, B, HW, C, G, relu, eps, st);
  return (int)run(static_cast<const float*>(x), g, bt, static_cast<const float*>(residual),
                  static_cast<float*>(out), m, r, p, B, HW, C, G, relu, eps, st);
}

}  // extern "C"
