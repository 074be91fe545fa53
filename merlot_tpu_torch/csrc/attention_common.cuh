// Helpers shared by the attention kernels (K1 attention_fwd.cu, K2
// attention_bwd.cu, K3 attention_stacked.cu). They recompute the same
// rounded, masked scores and the same softmax from them, so those steps
// live here once: the backward rebuilds the forward's probabilities with
// the same fp32 operations. K4 (groupnorm.cu) and K5 (ln_matmul.cu) take
// the type, rounding, warp-sum and launch helpers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace merlot {

constexpr float kMaskPenalty = 1e10f;
// the longest sequence of the fp32 routes and K3 (their tile lists are
// sized by it), and of K1/K2's bf16 route
constexpr int kMaxSeq = 2048;
constexpr int kMaxSeqBf16 = 4096;
constexpr int kMaxHeadDim = 128;
// MLA's heads (K1/K2's bf16 route only): Q.K at 192, P.V at 128
constexpr int kMlaQkDim = 192;
constexpr int kMlaVDim = 128;
constexpr size_t kMaxSmem = 227 * 1024;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and widened back to fp32
template <typename T>
__device__ __forceinline__ float round_as(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float round_sm(float x, bool sm_bf16) {
  return sm_bf16 ? round_as<bf16>(x) : x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the rounded, masked score of (query row, key kk) from its fp32 dot product
__device__ __forceinline__ float masked_score(float acc, const float* mask,
                                              size_t mask_row, int kk,
                                              float scale, bool sm_bf16) {
  float s = round_sm(acc * scale, sm_bf16);
  if (mask != nullptr) {
    const float m = mask[mask_row + kk];
    s = round_sm(s * m - kMaskPenalty * (1.f - m), sm_bf16);
  }
  return s;
}

// a probability rebuilt from its score and its row's max and sum (K3's
// decode kernel)
__device__ __forceinline__ float prob_from_stats(float s, float mx, float sum,
                                                 bool sm_bf16) {
  return round_sm(expf(s - mx) / sum, sm_bf16);
}

// e / sum, correctly rounded, from r = 1/sum correctly rounded: one FMA
// correction of e * r (Markstein) instead of a division per element. K1
// and K2 both take p from it, so K2's P is K1's bit for bit.
__device__ __forceinline__ float div_rn(float e, float sum, float r) {
  const float q = __fmul_rn(e, r);
  return fmaf(fmaf(-q, sum, e), r, q);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename K, typename... Args>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// the colsum's cotangent term of one key: g_colsum / H (K2, both routes)
__device__ __forceinline__ float gcol_term(const float* gcol, size_t i, int H) {
  return gcol == nullptr ? 0.f : gcol[i] / (float)H;
}

}  // namespace merlot
