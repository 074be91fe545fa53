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

constexpr int kKeyChunk = 64;  // keys staged per round trip by the FMA kernels
constexpr float kMaskPenalty = 1e10f;
constexpr int kMaxSeq = 2048;
constexpr int kMaxHeadDim = 128;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kQRows = 16;  // query rows per tile of the FMA kernels

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

// a probability rebuilt from its score and its row's max and sum: the same
// fp32 operations as softmax_rows, so the same bits
__device__ __forceinline__ float prob_from_stats(float s, float mx, float sum,
                                                 bool sm_bf16) {
  return round_sm(expf(s - mx) / sum, sm_bf16);
}

// softmax over each real row of s_p (row stride `ld`), in place, one warp
// per row; the rows' max and sum go to row_max/row_sum when those are given
__device__ void softmax_rows(float* s_p, int ld, int rows, int Sk, bool sm_bf16,
                             float* row_max = nullptr, float* row_sum = nullptr) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  for (int row = warp; row < rows; row += n_warps) {
    float* prow = s_p + (size_t)row * ld;
    float mx = -INFINITY;
    for (int j = lane; j < Sk; j += 32) mx = fmaxf(mx, prow[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < Sk; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < Sk; j += 32) prow[j] = round_sm(prow[j] / sum, sm_bf16);
    if (lane == 0 && row_max != nullptr) {
      row_max[row] = mx;
      row_sum[row] = sum;
    }
  }
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

}  // namespace merlot
