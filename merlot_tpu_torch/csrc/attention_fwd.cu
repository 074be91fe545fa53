// Fused multi-head attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces merlot_tpu/ops/pallas_attention.py `_flash_fwd` / `_attn_kernel`
// (the Pallas TPU kernel). It computes the same function:
//   per head h:  s   = (q_h . k_h^T) * scale        fp32 dot products
//                s   = round_sm(s)                  softmax dtype (fp32 or bf16)
//                s   = round_sm(s*m - 1e10*(1-m))   if a mask is given
//                p   = round_sm(softmax(s))         fp32 max/exp/sum
//                ctx = round_T(p) . v_h             fp32 accumulation, stored as T
//   colsum[b, k] = (1/H) * sum_h sum_{real q rows} p   (optional, fp32)
// on the natural [B, S, H*D] layout of q/k/v/ctx, so no transposes happen
// outside. The rounding points are the TPU kernel's: in the bf16-softmax
// mode the scores are rounded to bf16 before the mask and the softmax.
// That is why each tile keeps its full score rows (no online rescaling,
// which would move those rounding points).
//
// Design. One thread block per (q tile, head, batch element):
//   1. scores: K is streamed through shared memory in chunks of 64 keys,
//      and the tile's rounded, masked scores are written to shared memory
//      as full fp32 rows [tile rows, Sk];
//   2. softmax: one warp per row over the full row (max, exp, sum);
//   3. colsum: per-tile column sums go to a [B, H, n_tiles, Sk] buffer,
//      reduced by a second, deterministic kernel (no atomics); the probs
//      are rounded to T in place, since the value product's operand is
//      probs.astype(q.dtype);
//   4. ctx: V is streamed in chunks of 64 keys, accumulating in fp32.
// Two kernels share phases 2 and 3, both on 16-row tiles with 8 warps:
//   - attention_fwd_mma (bf16, head dim a multiple of 16): both products
//     run on the tensor cores as mma.sync.m16n8k16 bf16 -> fp32, with Q
//     held in registers and K/V staged row-major in shared memory with
//     16-byte loads (V's fragments are transposed by ldmatrix.trans);
//   - attention_fwd_fma (fp32): both products as fp32 FMAs from shared
//     memory. bf16 with another head dim is refused.
// Both live in attention_fwd_tiles.cuh, which K3's prefill (the stacked
// KV cache, attention_stacked.cu) shares; this file adds the colsum.
//
// What bounds it on the H100. Per head the two products cost
// 4*Sq*Sk*D flops against ~Sq*Sk exponentials, and the full score rows of
// a tile take rows*Sk*4 bytes of shared memory (57 KB at 16 rows and
// Sk=885). That caps the tile height, so each K/V chunk staged in shared
// memory serves only 16 query rows and K/V are re-read from L2 once per
// tile; the softmax makes three passes over the score rows in shared
// memory. With the products on mma.sync, the kernel is bound by those
// shared-memory passes and the per-tile K/V staging rather than by the
// tensor cores: it is latency-bound, so occupancy decides its speed. The
// 16-row tile keeps the score rows small; 8 warps per block (4 blocks, 32
// warps per SM) beat 4 warps at the zero-shot shapes, and 128- or 256-key
// staging chunks lost to 64 by costing resident blocks. wgmma on 64-row
// tiles with TMA-staged K/V is the next step.

#include "attention_fwd_tiles.cuh"

namespace {

using namespace merlot;

// ---------------------------------------------------------------------------
// colsum[b, k] = (1/H) * sum over heads and q tiles of the per-tile sums
__global__ void colsum_reduce_kernel(const float* __restrict__ part,
                                     float* __restrict__ colsum, int B, int H,
                                     int n_tiles, int Sk) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * Sk) return;
  const int b = idx / Sk, j = idx % Sk;
  float total = 0.f;
  for (int h = 0; h < H; ++h) {
    const float* p = part + ((size_t)b * H + h) * n_tiles * Sk + j;
    float hs = 0.f;
    for (int t = 0; t < n_tiles; ++t) hs += p[(size_t)t * Sk];
    total += hs;
  }
  colsum[idx] = total / H;
}

}  // namespace

extern "C" {

// Query rows per block; the caller sizes the colsum workspace as
// B * H * ceil(Sq / tile) * Sk floats.
int merlot_attention_fwd_q_tile(void) { return kQRows; }

// q/out: [B, Sq, H*D]; k/v: [B, Sk, H*D], all contiguous, fp32 (is_bf16=0)
// or bf16 (is_bf16=1, D a multiple of 16). mask: [B, Sq, Sk] fp32 or NULL.
// colsum_part/colsum: workspace and [B, Sk] fp32 output, both NULL when no
// colsum is wanted. Launches on `stream` and returns a cudaError_t (0 on
// success).
int merlot_attention_fwd(const void* q, const void* k, const void* v,
                         const void* mask, void* out, void* colsum_part,
                         void* colsum, int B, int Sq, int Sk, int H, int D,
                         int is_bf16, int softmax_fp32, float scale,
                         void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || D <= 0 || Sq > kMaxSeq ||
      Sk > kMaxSeq || D > kMaxHeadDim || B > 65535 || H > 65535 ||
      (is_bf16 && D % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if ((colsum_part == nullptr) != (colsum == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(colsum_part);
  const cudaError_t err = launch_fwd_tiles(
      q, k, v, static_cast<const float*>(mask), out, part, B, Sq, Sk, H, D,
      H * D, (size_t)Sq * Sk, is_bf16 != 0, softmax_fp32 == 0, scale, st);
  if (err != cudaSuccess || colsum == nullptr) return (int)err;
  const int n_tiles = (Sq + kQRows - 1) / kQRows;
  const int threads = 256;
  const int blocks = (B * Sk + threads - 1) / threads;
  colsum_reduce_kernel<<<blocks, threads, 0, st>>>(
      part, static_cast<float*>(colsum), B, H, n_tiles, Sk);
  return (int)cudaGetLastError();
}

}  // extern "C"
