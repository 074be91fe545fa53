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
// What bounds it on the H100. A decode step (Sq = 1) does 4*Sk*D flops per
// head against 4*Sk*D bytes of bf16 cache: one flop per byte, far below the
// ~295 at which the tensor cores would be the limit. So it is bound by
// reading the cache once: at B=8, Sk=1537, H*D=1024 bf16 that is 50 MB, ~15
// us at 3.35 TB/s, and the server makes 24 such launches per token.
//
// Design. Two paths, by the number of query rows:
//   - Sq <= 8 (decode): attention_decode, one block of 8 warps per (head,
//     batch element) holding every query row, since a 16-row mma tile would
//     waste at least 15/16 of its work. Each key row of the head is read by
//     a group of `lanes` threads, 16 bytes each (8 lanes for D=64 in bf16),
//     so a warp reads 32/lanes whole rows per load, and every thread keeps
//     4 such loads in flight before it uses them. Keys are read once from
//     the stacked rows (row stride 2*H*D); the group's partial dot products
//     meet by shuffles, and the rounded, masked scores of every query row
//     go to shared memory over the full key range (8 x 2048 x 4 B at most).
//     The softmax runs over each full row (softmax_rows, the TPU kernel's
//     rounding points), the probs are rounded to T, and the values are
//     read once, at column offset H*D, with fp32 partial sums per lane. The
//     partials of a warp meet by shuffles and the 8 warps' sums are added in
//     a fixed order from shared memory: deterministic, no atomics. At B=8 x
//     16 heads it launches 128 blocks, about one wave on 132 SMs.
//   - Sq > 8 (prefill): K1's tiled kernels (attention_fwd_tiles.cuh): for
//     bf16 the wgmma kernel (64-row q tiles, two passes over TMA-staged
//     64-key tiles, no score rows in shared memory), its K and V tensor
//     maps both over the cache (row stride 2*H*D, values from column H*D)
//     and one mask for the batch (mask_bs = 0); for fp32 the FMA kernel.
// Not done yet: splitting the keys over more blocks at batch 1 (16 blocks
// on 132 SMs), and skipping cache slots past the position, whose probs are
// exactly 0.

#include "attention_fwd_tiles.cuh"

namespace {

using namespace merlot;

constexpr int kDecodeRows = 8;   // Sq at or below this takes the decode kernel
constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecUnroll = 4;    // 16-byte loads each thread keeps in flight

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
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

// One block per (head, batch element), every query row (Sq <= MAXQ). A key
// row of the head is D elements = D / VE 16-byte vectors, read by `lanes`
// threads (that count rounded up to a power of two; the extra lanes idle).
template <typename T, int MAXQ>
__global__ void __launch_bounds__(kDecThreads)
attention_decode(const T* __restrict__ q, const T* __restrict__ kv,
                 const float* __restrict__ mask, T* __restrict__ out,
                 int Sq, int Sk, int H, int D, int lanes, size_t mask_bs,
                 float scale, bool sm_bf16) {
  constexpr int VE = 16 / sizeof(T);
  extern __shared__ float smem[];
  float* s_p = smem;                      // [Sq][Sk] scores, then probs
  float* s_red = s_p + (size_t)Sq * Sk;   // [kDecWarps][Sq][D] warp partials

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane % lanes;           // this thread's vector of the row
  const int grp = lane / lanes;           // this thread's key within the warp
  const int groups = 32 / lanes;
  const int stride = kDecWarps * groups;  // keys per round of the block
  const int first = warp * groups + grp;
  const bool active = sub * VE < D;
  const size_t hd = (size_t)H * D, row = 2 * hd;
  const T* kb = kv + (size_t)b * Sk * row + (size_t)h * D + sub * VE;
  const T* vb = kb + hd;
  const size_t mask_b = (size_t)b * mask_bs;

  float qf[MAXQ][VE];
#pragma unroll
  for (int r = 0; r < MAXQ; ++r) {
    if (r < Sq && active) {
      unpack(ldg16(q + ((size_t)b * Sq + r) * hd + (size_t)h * D + sub * VE), qf[r]);
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e) qf[r][e] = 0.f;
    }
  }

  // 1. scores: rounded, masked, into s_p
  for (int k0 = 0; k0 < Sk; k0 += stride * kDecUnroll) {
    uint4 buf[kDecUnroll];
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      const int key = k0 + u * stride + first;
      buf[u] = active && key < Sk ? ldg16(kb + (size_t)key * row)
                                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      const int key = k0 + u * stride + first;
      float kf[VE];
      unpack(buf[u], kf);
      float s[MAXQ];
#pragma unroll
      for (int r = 0; r < MAXQ; ++r) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < VE; ++e) a = fmaf(qf[r][e], kf[e], a);
        s[r] = a;
      }
      for (int o = lanes / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < MAXQ; ++r) s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
      }
      if (sub == 0 && key < Sk) {
#pragma unroll
        for (int r = 0; r < MAXQ; ++r) {
          if (r < Sq)
            s_p[(size_t)r * Sk + key] = masked_score(
                s[r], mask, mask_b + (size_t)r * Sk, key, scale, sm_bf16);
        }
      }
    }
  }
  __syncthreads();

  // 2. softmax over each full row; the value product's operand is p.astype(T)
  softmax_rows(s_p, Sk, Sq, Sk, sm_bf16);
  __syncthreads();
  for (int i = tid; i < Sq * Sk; i += kDecThreads) s_p[i] = round_as<T>(s_p[i]);
  __syncthreads();

  // 3. ctx = P . V: per-thread fp32 partials over the keys it reads
  float acc[MAXQ][VE];
#pragma unroll
  for (int r = 0; r < MAXQ; ++r)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[r][e] = 0.f;
  for (int k0 = 0; k0 < Sk; k0 += stride * kDecUnroll) {
    uint4 buf[kDecUnroll];
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      const int key = k0 + u * stride + first;
      buf[u] = active && key < Sk ? ldg16(vb + (size_t)key * row)
                                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kDecUnroll; ++u) {
      const int key = k0 + u * stride + first;
      if (key >= Sk) continue;
      float vf[VE];
      unpack(buf[u], vf);
#pragma unroll
      for (int r = 0; r < MAXQ; ++r) {
        if (r < Sq) {
          const float p = s_p[(size_t)r * Sk + key];
#pragma unroll
          for (int e = 0; e < VE; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
        }
      }
    }
  }
  // the warp's key groups meet by shuffles (lanes with the same `sub`) ...
  for (int o = lanes; o < 32; o <<= 1) {
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
  // ... and the warps' sums are added in a fixed order
  T* ob = out + (size_t)b * Sq * hd + (size_t)h * D;
  for (int i = tid; i < Sq * D; i += kDecThreads) {
    const int r = i / D, d = i % D;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) t += s_red[((size_t)w * Sq + r) * D + d];
    ob[(size_t)r * hd + d] = from_float<T>(t);
  }
}

size_t decode_smem(int Sq, int Sk, int D) {
  return sizeof(float) * ((size_t)Sq * Sk + (size_t)kDecWarps * Sq * D);
}

template <typename T>
cudaError_t launch_decode(const void* q, const void* kv, const float* mask,
                          void* out, int B, int Sq, int Sk, int H, int D,
                          size_t mask_bs, float scale, bool sm_bf16,
                          cudaStream_t st) {
  constexpr int VE = 16 / sizeof(T);
  if (D % VE != 0 || D / VE > 32) return cudaErrorInvalidValue;
  int lanes = 1;
  while (lanes < D / VE) lanes <<= 1;
  const size_t smem = decode_smem(Sq, Sk, D);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid(H, B);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(kv);
  T* oo = static_cast<T*>(out);
  if (Sq == 1)
    return launch(attention_decode<T, 1>, grid, kDecThreads, smem, st, qq, kk,
                  mask, oo, Sq, Sk, H, D, lanes, mask_bs, scale, sm_bf16);
  return launch(attention_decode<T, kDecodeRows>, grid, kDecThreads, smem, st,
                qq, kk, mask, oo, Sq, Sk, H, D, lanes, mask_bs, scale, sm_bf16);
}

}  // namespace

extern "C" {

// q/out: [B, Sq, H*D]; kv: [B, Sk, 2*H*D] with keys in columns [:H*D] and
// values in [H*D:]; all contiguous and 16-byte aligned, fp32 (is_bf16=0,
// D a multiple of 4) or bf16 (is_bf16=1, D a multiple of 16). mask: fp32
// [B, Sq, Sk] (mask_batched=1), one [1, Sq, Sk] for every batch element
// (mask_batched=0), or NULL. Launches on `stream` and returns a
// cudaError_t (0 on success).
int merlot_attention_stacked_fwd(const void* q, const void* kv, const void* mask,
                                 void* out, int B, int Sq, int Sk, int H, int D,
                                 int mask_batched, int is_bf16, int softmax_fp32,
                                 float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || D <= 0 || Sq > kMaxSeq ||
      Sk > kMaxSeq || D > kMaxHeadDim || B > 65535 || H > 65535 ||
      (is_bf16 ? D % 16 != 0 : D % 4 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const size_t mask_bs = mask_batched ? (size_t)Sq * Sk : 0;
  const bool sm_bf16 = is_bf16 && softmax_fp32 == 0;
  cudaError_t err;
  if (Sq <= kDecodeRows) {
    err = is_bf16 ? launch_decode<bf16>(q, kv, m, out, B, Sq, Sk, H, D, mask_bs,
                                        scale, sm_bf16, st)
                  : launch_decode<float>(q, kv, m, out, B, Sq, Sk, H, D, mask_bs,
                                         scale, sm_bf16, st);
  } else {
    err = launch_fwd_tiles(q, kv, kv, H * D, m, out, nullptr, nullptr, B, Sq, Sk, H, D,
                           2 * H * D, mask_bs, is_bf16 != 0, sm_bf16, scale, st);
  }
  return (int)err;
}

}  // extern "C"
