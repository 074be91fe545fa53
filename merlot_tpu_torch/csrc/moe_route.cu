// The routing step of the DeepSeek-V3 expert layer (models/moe_lm.py,
// nn/moe.py) in one launch, plain C interface: ops/moe_route.py.
//
// Per token t of T (rows of S tokens each, T = B * S), over E experts:
//   s      = sigmoid(logit)                      fp32, 1 / (1 + expf(-x))
//   chosen = the K largest of s + bias           ties to the lower expert
//   w_k    = (s_k / sum of the chosen s) * scale  in rank order
// then the counts over all E experts (the whole batch's, and each row's),
// and the permutation of the experts this share holds (held0 .. held0 +
// n_held - 1): their picks laid out expert by expert, tokens in order,
// each expert's rows padded to a multiple of 16 (offs: the padded ends).
// row_tk[r] is the flat pick t * K + k of row r, T * K for a pad or unused
// row. stats: the picks of held experts, those of them not placed (0: the
// layer is dropless), and the busiest held expert's picks over the held
// experts' mean. The correction bias is read only: the training step moves
// it once a step from the counts (models/moe_lm.py).
//
// merlot_moe_gather, the second launch of the library, copies each picked
// token's row of the layer's bf16 input into the layout's rows, up to the
// last held expert's end (offs[n_held - 1], read on the card), 0 on pad rows.
//
// Design: one block of 1024 threads, two passes over the tokens, so every
// output is deterministic and nothing is read back by the host.
//   1. a thread per token: the scores, a sorted list of the K best kept
//      in registers as the E scores stream by, the weights, and the counts
//      by shared-memory integer atomics (exact in any order);
//   2. after the counts, the held experts' offsets, then the tokens again
//      in blocks of 1024: each held expert's picks ranked within a warp by
//      a ballot and across the warps by a scan in shared memory, so each
//      expert's rows keep the tokens' order.
// One block reads the T x E scores (2 MB at T 8192, E 64) once and writes
// what it needs to; a grid would need a second launch or a last-block
// handshake for the offsets.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;       // experts per token
constexpr int kMaxHeld = 32;   // held experts (one ballot bit each)
constexpr int kAlign = 16;     // rows of a held expert's group, padded to this

__global__ void __launch_bounds__(kThreads, 1)
moe_route_kernel(const float* __restrict__ logits, const float* __restrict__ bias, int T,
                 int E, int K, int S, int held0, int n_held, float scale,
                 int* __restrict__ idx, float* __restrict__ w, int* __restrict__ counts,
                 int* __restrict__ seq_counts, int* __restrict__ offs,
                 int* __restrict__ row_tk, float* __restrict__ stats, int rows) {
  extern __shared__ int smem[];
  float* s_bias = reinterpret_cast<float*>(smem);         // [E]
  int* s_count = smem + E;                                 // [E]
  int* s_seq = s_count + E;                                // [T / S][E]
  int* s_warp = s_seq + (T / S) * E;                       // [warps][n_held]
  int* s_base = s_warp + kWarps * n_held;                  // [n_held] group starts
  int* s_cursor = s_base + n_held;                         // [n_held] rows placed
  int* s_placed = s_cursor + n_held;                       // [1]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_seq = T / S;

  for (int e = tid; e < E; e += kThreads) {
    s_bias[e] = bias[e];
    s_count[e] = 0;
  }
  for (int i = tid; i < n_seq * E; i += kThreads) s_seq[i] = 0;
  for (int l = tid; l < n_held; l += kThreads) s_cursor[l] = 0;
  if (tid == 0) *s_placed = 0;
  // every row starts as a pad row
  for (int r = tid; r < rows; r += kThreads) row_tk[r] = T * K;
  __syncthreads();

  // pass 1: the choice, the weights, the counts
  for (int t = tid; t < T; t += kThreads) {
    float best[kMaxK], best_s[kMaxK];
    int best_e[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) best[k] = -INFINITY, best_s[k] = 0.f, best_e[k] = -1;
    const float* x = logits + (size_t)t * E;
    for (int e = 0; e < E; ++e) {
      const float s = 1.f / (1.f + expf(-x[e]));
      const float v = s + s_bias[e];
      // insert after every listed score >= v (ties keep the lower expert
      // first); nothing if v is not above the K-th
      float last = best[0];
#pragma unroll
      for (int k = 1; k < kMaxK; ++k)
        if (k == K - 1) last = best[k];
      if (!(v > last)) continue;
      bool placed = false;
#pragma unroll
      for (int k = kMaxK - 1; k > 0; --k) {
        if (k >= K || placed) continue;
        if (v > best[k - 1]) {
          best[k] = best[k - 1], best_s[k] = best_s[k - 1], best_e[k] = best_e[k - 1];
        } else {
          best[k] = v, best_s[k] = s, best_e[k] = e;
          placed = true;
        }
      }
      if (!placed) best[0] = v, best_s[0] = s, best_e[0] = e;
    }
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) sum += best_s[k];
    const int b = t / S;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k >= K) continue;
      idx[(size_t)t * K + k] = best_e[k];
      w[(size_t)t * K + k] = (best_s[k] / sum) * scale;
      atomicAdd(&s_count[best_e[k]], 1);
      atomicAdd(&s_seq[b * E + best_e[k]], 1);
    }
  }
  __syncthreads();

  for (int e = tid; e < E; e += kThreads) counts[e] = s_count[e];
  for (int i = tid; i < n_seq * E; i += kThreads) seq_counts[i] = s_seq[i];
  if (tid == 0) {
    int end = 0;
    for (int l = 0; l < n_held; ++l) {
      s_base[l] = end;
      end += (s_count[held0 + l] + kAlign - 1) / kAlign * kAlign;
      offs[l] = end;
    }
  }
  __syncthreads();

  // pass 2: the held experts' rows, tokens in order within each expert
  const unsigned below = (1u << lane) - 1u;
  int placed = 0;
  for (int t0 = 0; t0 < T; t0 += kThreads) {
    const int t = t0 + tid;
    int pick[kMaxK], rank[kMaxK];  // each pick's held expert (or -1) and rank in the warp
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      pick[k] = -1;
      rank[k] = 0;
      if (k < K && t < T) {
        const int l = idx[(size_t)t * K + k] - held0;
        if (l >= 0 && l < n_held) pick[k] = l;
      }
    }
    for (int l = 0; l < n_held; ++l) {
      bool has = false;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) has |= pick[k] == l;
      const unsigned ballot = __ballot_sync(0xffffffffu, has);
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (pick[k] == l) rank[k] = __popc(ballot & below);
      if (lane == 0) s_warp[warp * n_held + l] = __popc(ballot);
    }
    __syncthreads();
    // each warp's first row of each expert: the rows placed before this
    // block of tokens, then the earlier warps' picks
    for (int l = tid; l < n_held; l += kThreads) {
      int run = s_cursor[l];
      for (int v = 0; v < kWarps; ++v) {
        const int c = s_warp[v * n_held + l];
        s_warp[v * n_held + l] = run;
        run += c;
      }
      s_cursor[l] = run;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      const int l = pick[k];
      if (l < 0) continue;
      const int row = s_base[l] + s_warp[warp * n_held + l] + rank[k];
      if (row < rows) {
        row_tk[row] = t * K + k;
        ++placed;
      }
    }
    __syncthreads();
  }
  atomicAdd(s_placed, placed);
  __syncthreads();
  if (tid == 0) {
    int held = 0, most = 0;
    for (int l = 0; l < n_held; ++l) {
      held += s_count[held0 + l];
      most = max(most, s_count[held0 + l]);
    }
    stats[0] = (float)held;
    stats[1] = (float)(held - *s_placed);
    stats[2] = held > 0 ? (float)most * (float)n_held / (float)held : 0.f;
  }
}

// One row of the layout a block at a time (grid-stride), 16 bytes a thread
// a step: x[r] = y[row_tk[r] / K], or 0 where row_tk[r] / K is T (a pad
// row), for r below the rows in use; the rows past them are left alone.
__global__ void moe_gather_kernel(const uint4* __restrict__ y, const int* __restrict__ row_tk,
                                  const int* __restrict__ end, uint4* __restrict__ x, int T,
                                  int K, int vecs, int rows) {
  const int n = min(*end, rows);
  for (int r = blockIdx.x; r < n; r += gridDim.x) {
    const int tok = row_tk[r] / K;
    uint4* dst = x + (size_t)r * vecs;
    if (tok < T) {
      const uint4* src = y + (size_t)tok * vecs;
      for (int v = threadIdx.x; v < vecs; v += blockDim.x) dst[v] = src[v];
    } else {
      for (int v = threadIdx.x; v < vecs; v += blockDim.x) dst[v] = make_uint4(0, 0, 0, 0);
    }
  }
}

}  // namespace

extern "C" {

// logits: [T, E] fp32; bias: [E] fp32.
// T = B * S tokens in rows of S. Outputs: idx [T, K] int32 (the chosen
// experts, rank order), w [T, K] fp32, counts [E] and seq_counts [B, E]
// int32, offs [n_held] int32 (each held expert's padded end row), row_tk
// [rows] int32, stats [3] fp32. rows must be at least
// held_rows(T, K, n_held) of ops/moe_route.py. Launches on `stream`; returns a
// cudaError_t (0 on success).
int merlot_moe_route(const void* logits, const void* bias, int T, int E, int K, int S,
                     int held0, int n_held, float scale, void* idx, void* w, void* counts,
                     void* seq_counts, void* offs, void* row_tk, void* stats, int rows,
                     void* stream) {
  if (T <= 0 || E <= 0 || S <= 0 || T % S != 0 || K <= 0 || K > kMaxK || K > E ||
      n_held <= 0 || n_held > kMaxHeld || held0 < 0 || held0 + n_held > E ||
      rows < T * (K < n_held ? K : n_held) + n_held * (kAlign - 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * ((size_t)2 * E + (size_t)(T / S) * E +
                                     (size_t)kWarps * n_held + 2 * (size_t)n_held + 1);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      moe_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  moe_route_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(bias), T, E, K, S, held0,
      n_held, scale, static_cast<int*>(idx), static_cast<float*>(w), static_cast<int*>(counts),
      static_cast<int*>(seq_counts), static_cast<int*>(offs), static_cast<int*>(row_tk),
      static_cast<float*>(stats), rows);
  return (int)cudaGetLastError();
}

// y: [T, H] bf16 with H a multiple of 8 and y, x 16-byte aligned; row_tk:
// [rows] int32 from merlot_moe_route; end: the int32 of the rows in use
// (offs[n_held - 1]), on the card; x: [rows, H] bf16, written below end.
// Launches on `stream`; returns a cudaError_t (0 on success).
int merlot_moe_gather(const void* y, const void* row_tk, const void* end, void* x, int T,
                      int K, int H, int rows, void* stream) {
  if (T <= 0 || K <= 0 || H <= 0 || H % 8 != 0 || rows <= 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = rows < 1024 ? rows : 1024;
  moe_gather_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(y), static_cast<const int*>(row_tk),
      static_cast<const int*>(end), static_cast<uint4*>(x), T, K, H / 8, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
