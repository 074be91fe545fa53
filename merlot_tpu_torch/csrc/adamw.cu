// Multi-tensor AdamW for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX package's update
// (merlot_tpu/train/optimizer.py) is a tree map over the leaves that XLA
// fuses under jit. Run leaf by leaf in ATen, the same update is ~34
// elementwise kernels a leaf plus ~3 for the global norm, thousands of
// launches a step that hold the card on the host. Here it is two launches
// a step over every leaf:
//
//   merlot_sumsq  per-leaf sums of squares of a list of fp32 tensors (the
//                 gradients: the global norm, the clip factor and the
//                 per-scope norms; the parameters: the weight-decay metric);
//   merlot_adamw  one pass over every non-frozen leaf: for each element
//                 g (times the clip factor read from device memory, when
//                 one is given), m and v (bf16 with the sign-bit v, or
//                 fp32) in; p, m and v out.
//
// Each element's arithmetic is the plain loop's (train/optimizer.py,
// adamw_leaf), one rounding per ATen op, in its order, written with the
// _rn intrinsics so that nvcc contracts none of them into an FMA:
//   m = b1*m + (1-b1)*g
//   v = b2*v + (1-b2)*(g*g + 1e-30)
//   u = m / (sqrt(v) + eps)
//   u = u + wd*p                    when wd > 0
//   p = p - lr*u
// with the bf16 state decoded and encoded as decode_v / encode_v do. The
// scalars come per hyperparameter group as float32, cast on the host from
// the Python doubles as ATen casts them.
//
// Layout: the wrapper (ops/cuda_adamw.py) uploads one table per list of
// leaves: a retirement counter, then per leaf four views (pointer and row
// stride: any narrow of a contiguous tensor is `rows` runs of `width`
// elements, `stride` apart), its group and its first chunk, then the
// chunks: (leaf, row, first column, length), at most CHUNK elements of
// one row. A persistent grid walks the chunks, so that one tiny leaf and a
// 38.7 M-element embedding both spread over the SMs; a chunk reads 16 bytes
// a thread where its pointers allow, with scalar heads and tails.
//
// The sums are deterministic, with no float atomics: each chunk's partial
// (fp64, in a fixed thread order) goes to memory; the last block to retire
// (an integer ticket) sums each leaf's partials in chunk order.
//
// What bounds it on the H100: bytes. The update reads p, g, m, v and writes
// p, m, v once: 20 bytes an element with bf16 state, 28 with fp32; the
// norm reads g once more (4 bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSumIlp = 4;  // 16-byte loads a thread of merlot_sumsq keeps in flight
constexpr int kMaxGroups = 32;
constexpr float kMissingPrecision = 1.00390625f;  // 1 + 2^-8

struct Leaf {
  long long ptr[4];     // p, g, m, v (merlot_sumsq: the tensor, in ptr[0])
  long long stride[4];  // elements between the rows of each view
  long long group;      // hyperparameter group (merlot_adamw)
  long long first;      // the leaf's first chunk (merlot_sumsq)
};

struct Chunk {
  int leaf, row, col, len;
};

// lr (with the schedule and the bias correction), b1, 1-b1, b2, 1-b2, eps,
// wd, and 1 where wd > 0
struct Group {
  float lr, b1, c1, b2, c2, eps, wd, has_wd;
};

struct Groups {
  Group g[kMaxGroups];
};

struct Tables {
  unsigned* counter;
  const Leaf* leaves;
  const Chunk* chunks;
};

__device__ __forceinline__ Tables tables(const long long* t, int n_leaves) {
  const Leaf* leaves = reinterpret_cast<const Leaf*>(t + 1);
  return {reinterpret_cast<unsigned*>(const_cast<long long*>(t)), leaves,
          reinterpret_cast<const Chunk*>(leaves + n_leaves)};
}

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// ---------------------------------------------------------------- sums

__device__ __forceinline__ double warp_sum(double s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// the block's sum in a fixed order (every thread gets it)
__device__ double block_sum(double s, double* red) {
  s = warp_sum(s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = s;
  __syncthreads();
  s = lane < kThreads / 32 ? red[lane] : 0.0;
  return warp_sum(s);
}

// out: per-leaf sums [n] fp32; partial: the chunks' partials in fp64
__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const long long* table, int n_leaves, int n_chunks, float* out,
             double* partial) {
  __shared__ double red[kThreads / 32];
  __shared__ bool last;
  const Tables tb = tables(table, n_leaves);
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk ch = tb.chunks[c];
    const Leaf& lf = tb.leaves[ch.leaf];
    const float* x = reinterpret_cast<const float*>(lf.ptr[0]) +
                     (long long)ch.row * lf.stride[0] + ch.col;
    const int head = min(ch.len, (int)(((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) >> 2));
    const int nvec = (ch.len - head) >> 2;
    double s = 0.0;
    for (int i = threadIdx.x; i < head; i += kThreads) s = fma((double)x[i], (double)x[i], s);
    const float4* xv = reinterpret_cast<const float4*>(x + head);
    for (int k0 = threadIdx.x; k0 < nvec; k0 += kThreads * kSumIlp) {
      float4 q[kSumIlp];
#pragma unroll
      for (int u = 0; u < kSumIlp; ++u) {
        const int k = k0 + u * kThreads;
        q[u] = k < nvec ? xv[k] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kSumIlp; ++u) {
        s = fma((double)q[u].x, (double)q[u].x, s);
        s = fma((double)q[u].y, (double)q[u].y, s);
        s = fma((double)q[u].z, (double)q[u].z, s);
        s = fma((double)q[u].w, (double)q[u].w, s);
      }
    }
    for (int i = head + 4 * nvec + threadIdx.x; i < ch.len; i += kThreads)
      s = fma((double)x[i], (double)x[i], s);
    s = block_sum(s, red);
    if (threadIdx.x == 0) partial[c] = s;
  }

  // the last block to retire finishes
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicInc(tb.counter, gridDim.x - 1) == gridDim.x - 1;  // wraps to 0
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int l = warp; l < n_leaves; l += kThreads / 32) {
    const long long first = tb.leaves[l].first;
    const long long end = l + 1 < n_leaves ? tb.leaves[l + 1].first : n_chunks;
    double s = 0.0;
    for (long long c = first + lane; c < end; c += 32) s += __ldcg(partial + c);
    s = warp_sum(s);
    if (lane == 0) out[l] = (float)s;
  }
}

// ---------------------------------------------------------------- update

// the stored moments: fp32 as they are; bf16 m plainly, bf16 v with the
// sign bit recording a x1.00390625 correction (encode_v / decode_v)
__device__ __forceinline__ float m_load(float s) { return s; }
__device__ __forceinline__ float v_load(float s) { return s; }
__device__ __forceinline__ float m_store(float x, float) { return x; }
__device__ __forceinline__ float v_store(float x, float) { return x; }

__device__ __forceinline__ float m_load(__nv_bfloat16 s) { return __bfloat162float(s); }
__device__ __forceinline__ float v_load(__nv_bfloat16 s) {
  const float f = __bfloat162float(s);
  const float a = fabsf(f);
  return f > 0.0f ? a : __fmul_rn(a, kMissingPrecision);
}
__device__ __forceinline__ __nv_bfloat16 m_store(float x, __nv_bfloat16) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ __nv_bfloat16 v_store(float v, __nv_bfloat16) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  const float bf = __bfloat162float(b);
  const float err0 = fabsf(__fsub_rn(bf, v));
  const float err1 = fabsf(__fsub_rn(__fmul_rn(bf, kMissingPrecision), v));
  return err0 <= err1 ? b : __ushort_as_bfloat16(__bfloat16_as_ushort(b) ^ 0x8000u);
}

// four consecutive elements, 16 bytes (fp32) or 8 (bf16) at once
__device__ __forceinline__ void load4(const float* p, float x[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
}
__device__ __forceinline__ void store4(float* p, const float x[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, __nv_bfloat16 x[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  x[0] = __ushort_as_bfloat16(q.x & 0xffffu), x[1] = __ushort_as_bfloat16(q.x >> 16);
  x[2] = __ushort_as_bfloat16(q.y & 0xffffu), x[3] = __ushort_as_bfloat16(q.y >> 16);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const __nv_bfloat16 x[4]) {
  uint2 q;
  q.x = __bfloat16_as_ushort(x[0]) | ((unsigned)__bfloat16_as_ushort(x[1]) << 16);
  q.y = __bfloat16_as_ushort(x[2]) | ((unsigned)__bfloat16_as_ushort(x[3]) << 16);
  *reinterpret_cast<uint2*>(p) = q;
}

template <typename S>
__device__ __forceinline__ void adamw_element(float& p, float g, S& m_s, S& v_s, const Group& h,
                                              bool clipped, float clip) {
  if (clipped) g = __fmul_rn(g, clip);
  const float m = __fadd_rn(__fmul_rn(h.b1, m_load(m_s)), __fmul_rn(h.c1, g));
  const float v = __fadd_rn(__fmul_rn(h.b2, v_load(v_s)),
                            __fmul_rn(h.c2, __fadd_rn(__fmul_rn(g, g), 1e-30f)));
  float u = __fdiv_rn(m, __fadd_rn(__fsqrt_rn(v), h.eps));
  if (h.has_wd != 0.0f) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, u));
  m_s = m_store(m, m_s);
  v_s = v_store(v, v_s);
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const long long* table, int n_leaves, int n_chunks, const float* clip_ptr,
             const __grid_constant__ Groups groups) {
  const Tables tb = tables(table, n_leaves);
  const bool clipped = clip_ptr != nullptr;
  const float clip = clipped ? *clip_ptr : 1.0f;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk ch = tb.chunks[c];
    const Leaf& lf = tb.leaves[ch.leaf];
    const Group& h = groups.g[lf.group];
    float* __restrict__ p =
        reinterpret_cast<float*>(lf.ptr[0]) + (long long)ch.row * lf.stride[0] + ch.col;
    const float* __restrict__ g =
        reinterpret_cast<const float*>(lf.ptr[1]) + (long long)ch.row * lf.stride[1] + ch.col;
    S* __restrict__ m = reinterpret_cast<S*>(lf.ptr[2]) + (long long)ch.row * lf.stride[2] + ch.col;
    S* __restrict__ v = reinterpret_cast<S*>(lf.ptr[3]) + (long long)ch.row * lf.stride[3] + ch.col;
    // a scalar head up to p's 16-byte boundary, if g, m and v then align too
    int head = min(ch.len, (int)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2));
    if (!(aligned(g + head, 16) && aligned(m + head, 4 * sizeof(S)) &&
          aligned(v + head, 4 * sizeof(S))))
      head = ch.len;
    const int nvec = (ch.len - head) >> 2;
    for (int i = threadIdx.x; i < head; i += kThreads)
      adamw_element(p[i], g[i], m[i], v[i], h, clipped, clip);
    for (int k = threadIdx.x; k < nvec; k += kThreads) {
      const int i = head + 4 * k;
      float pv[4], gv[4];
      S mv[4], vv[4];
      load4(p + i, pv);
      load4(g + i, gv);
      load4(m + i, mv);
      load4(v + i, vv);
#pragma unroll
      for (int j = 0; j < 4; ++j) adamw_element(pv[j], gv[j], mv[j], vv[j], h, clipped, clip);
      store4(p + i, pv);
      store4(m + i, mv);
      store4(v + i, vv);
    }
    for (int i = head + 4 * nvec + threadIdx.x; i < ch.len; i += kThreads)
      adamw_element(p[i], g[i], m[i], v[i], h, clipped, clip);
  }
}

}  // namespace

extern "C" {

// Per-leaf sums of squares of the table's fp32 tensors into out[0:n];
// scratch holds n_chunks doubles. Returns cudaGetLastError().
int merlot_sumsq(const long long* table, int n_leaves, int n_chunks, float* out,
                 double* scratch, int grid, cudaStream_t stream) {
  sumsq_kernel<<<grid, kThreads, 0, stream>>>(table, n_leaves, n_chunks, out, scratch);
  return (int)cudaGetLastError();
}

// One AdamW step over the table's leaves: n_groups rows of 8 float32
// (struct Group) on the host; clip: a device float or null; state_bf16:
// bf16 moments with the sign-bit v, else fp32. Returns cudaGetLastError()
// (-1 for more than kMaxGroups groups).
int merlot_adamw(const long long* table, int n_leaves, int n_chunks, const float* groups,
                 int n_groups, const float* clip, int state_bf16, int grid,
                 cudaStream_t stream) {
  if (n_groups < 0 || n_groups > kMaxGroups) return -1;
  Groups gs = {};
  for (int i = 0; i < n_groups; ++i) {
    const float* r = groups + 8 * i;
    gs.g[i] = {r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7]};
  }
  if (state_bf16)
    adamw_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(table, n_leaves, n_chunks,
                                                                clip, gs);
  else
    adamw_kernel<float><<<grid, kThreads, 0, stream>>>(table, n_leaves, n_chunks, clip, gs);
  return (int)cudaGetLastError();
}

// Blocks of each kernel an SM holds at once (which: 0 merlot_sumsq, 1 the
// update over fp32 moments, 2 over bf16), or -1 if the query failed: the
// persistent grids' size
int merlot_adamw_blocks_per_sm(int which) {
  int n = -1;
  cudaError_t err =
      which == 0   ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sumsq_kernel, kThreads, 0)
      : which == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, adamw_kernel<float>,
                                                                   kThreads, 0)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &n, adamw_kernel<__nv_bfloat16>, kThreads, 0);
  return err == cudaSuccess ? n : -1;
}

}  // extern "C"
