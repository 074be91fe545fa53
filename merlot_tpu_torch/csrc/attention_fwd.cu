// Fused multi-head attention forward for Hopper (sm_90a), plain C interface:
// K1.
//
// Replaces merlot_tpu/ops/pallas_attention.py `_flash_fwd` (:198, its
// pallas_call at :273) and its body `_attn_kernel` (:80), the Pallas TPU
// kernel. It computes the same function:
//   per head h:  s   = (q_h . k_h^T) * scale        fp32 dot products
//                s   = round_sm(s)                  softmax dtype (fp32 or bf16)
//                s   = round_sm(s*m - 1e10*(1-m))   if a mask is given
//                p   = round_sm(exp(s - max) / sum) fp32 max/exp/sum
//                ctx = round_T(p) . v_h             fp32 accumulation, stored as T
//   colsum[b, k] = (1/H) * sum_h sum_{real q rows} p   (optional, fp32)
// on the natural [B, S, H*D] layout of q/k/v/ctx, so no transposes happen
// outside. The rounding points are the TPU kernel's: in the bf16-softmax
// mode the scores are rounded to bf16 before the mask and the softmax, and
// p is rounded after the division, so P . V is not linear in exp(s - max):
// no online rescaling. Keys at or past Sk take no part in the max or the
// sum; masked keys do (a fully masked row is uniform over the true Sk).
//
// Design (attention_fwd_tiles.cuh; bf16, D a multiple of 16 up to 128,
// templated on D). A warpgroup (128 threads) per 64 query rows; a block is
// one (q tile, head, batch element). Q is staged once; K, and V in the last
// pass, stream through a 2-stage ring of 64-key tiles loaded by TMA
// (cp.async.bulk.tensor with mbarriers) from 3-D tensor maps [B, Sk, H*D]
// (row stride kv_ld), so the ragged Sk edge arrives zero-filled and is never
// the next batch element's rows. Tiles are 64-column blocks with 128-byte
// swizzle (16-column blocks with 32-byte swizzle when D is not a multiple
// of 64: sm90.cuh). No score row is kept in shared memory; two passes over
// the K stream instead:
//   1. S = Q . K^T (wgmma m64n64k16, both operands from shared memory),
//      rounded and masked: the row max (exact in any order) and the row sum
//      of exp(s - max) in fp32, rescaled by exp(old max - new max) when a
//      tile raises the max, the row's four threads combined at the end;
//   2. in a loop of its own (so that ctx's accumulator is not live in pass
//      1), S again: p = round_sm(exp(s - max) / sum), the tile's column sums
//      over real rows (a fixed order: the thread's two rows, the warp's rows
//      by shuffles, the warps from shared memory), then ctx +=
//      round_bf16(p) . V (wgmma with A from registers, converted from S's
//      accumulator layout).
// A three-pass form (max, then sum, then p) ran first; the ablation
// measured its max pass at ~0.23 ms of the ViT shape's 0.92 ms (H100 80GB
// HBM3, 700 W), so the max and the sum share one pass. The sum is still
// fp32 over the same exps (to rounding), and K2 takes it from here, so P is
// the same bits in both. The mask is read from memory once per tile in
// pass 1 and kept as one bit per element in shared memory when the block's
// mask holds only 0 and 1 (m = 1 leaves the score, m = 0 gives
// round_sm(-1e10): the formula's own values); any other value keeps the
// memory reads. exp is 2^(x log2 e) on the special-function unit
// (ex2.approx, a few fp32 ulps) rather than expf: the element work bounds
// the kernel, and with the separate loops that cut it 12-17% at the path
// shapes and K2 5% per train step (chip_smoke.py; H100 80GB HBM3, 700 W). The
// division is exp * (1/sum) corrected by one FMA (correctly rounded, as the
// division is). The row max and sum are saved
// when asked ([2, B, H, Sq] fp32) for K2. The per-tile colsum partials go to
// [B, H, q tiles, Sk] and a second kernel (below) reduces them in a fixed
// order: deterministic, no atomics. fp32 inputs run attention_fp32.cuh's
// kernel (the same two passes on 64 x 64 tiles of fp32 FMAs, the masked
// tiles skipped; its header says how). The block's registers are capped at 128 a thread so that four
// blocks (16 warps) share an SM. Timed against this shape at d = 64 and
// slower at the train step's shapes (H100 80GB HBM3, 700 W): no cap; two
// warpgroups per block, capped alike (faster only at the zero-shot ViT
// shape); a 3-stage ring; the next tile's S started before this one's
// element work (in pass 1 alone, ptxas serialized the in-flight product).
//
// What bounds it on the H100. At the train step's shapes (d = 64) the bound
// is the bytes: q, k, v and ctx once each (plus the mask) take 0.010-0.062
// ms at 3.35 TB/s against 0.007-0.028 ms for the 4*Sq*Sk*D flops at the bf16
// peak. The kernel runs S twice, re-reads K (and V) from L2 once per 64
// query rows, and does the softmax's element work in registers. What bounds
// it is that element work's instruction issue (~1 us of SM time per 64x64
// tile and pass at the ViT shape) and one warpgroup's serial chain per tile
// (TMA wait, wgmma, the element work, a barrier), hidden only by the blocks
// resident on an SM: the ablation's mm_only (one pass, no softmax) is
// already 1.5x SDPA's time.

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

// q/out: [B, Sq, H*D]; k/v: [B, Sk, H*D], all contiguous and 16-byte
// aligned, fp32 (is_bf16=0) or bf16 (is_bf16=1, D a multiple of 16). mask:
// [B, Sq, Sk] fp32 or NULL. colsum_part/colsum: workspace of B * H *
// ceil(Sq / 64) * Sk floats and [B, Sk] fp32 output, both NULL when no
// colsum is wanted. stats: NULL, or [2, B, H, Sq]
// fp32 that receives each row's softmax max and sum, which K2 takes
// instead of recomputing them. tile_class: with fp32 inputs and a mask,
// [B][q tiles][key tiles] bytes that receive the mask's tile classes (K2
// takes them too); else ignored. variant: 0 (the kernel); 1 and 2 are
// the ablation probe's mm_only and no_max (bf16, D = 64; wrong on purpose,
// no model path asks for them). Launches on `stream` and returns a
// cudaError_t (0 on success).
int merlot_attention_fwd_variant(const void* q, const void* k, const void* v,
                                 const void* mask, void* out, void* colsum_part,
                                 void* colsum, void* stats, void* tile_class, int B, int Sq,
                                 int Sk, int H, int D, int is_bf16, int softmax_fp32,
                                 float scale, void* stream, int variant) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || D <= 0 || Sq > kMaxSeq ||
      Sk > kMaxSeq || D > kMaxHeadDim || B > 65535 || H > 65535 ||
      (is_bf16 && D % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if ((colsum_part == nullptr) != (colsum == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(colsum_part);
  const cudaError_t err = launch_fwd_tiles(
      q, k, v, 0, static_cast<const float*>(mask), out, part, static_cast<float*>(stats),
      static_cast<uint8_t*>(tile_class), B, Sq, Sk, H, D, H * D, (size_t)Sq * Sk,
      is_bf16 != 0, is_bf16 != 0 && softmax_fp32 == 0, scale, st, variant);
  if (err != cudaSuccess || colsum == nullptr) return (int)err;
  const int n_tiles = (Sq + sm90::kTileRows - 1) / sm90::kTileRows;
  const int threads = 256;
  const int blocks = (B * Sk + threads - 1) / threads;
  colsum_reduce_kernel<<<blocks, threads, 0, st>>>(
      part, static_cast<float*>(colsum), B, H, n_tiles, Sk);
  return (int)cudaGetLastError();
}

int merlot_attention_fwd(const void* q, const void* k, const void* v,
                         const void* mask, void* out, void* colsum_part,
                         void* colsum, void* stats, void* tile_class, int B, int Sq,
                         int Sk, int H, int D, int is_bf16, int softmax_fp32, float scale,
                         void* stream) {
  return merlot_attention_fwd_variant(q, k, v, mask, out, colsum_part, colsum, stats,
                                      tile_class, B, Sq, Sk, H, D, is_bf16, softmax_fp32,
                                      scale, stream, kProd);
}

}  // extern "C"
