// K1's bf16 kernel (attention_fwd.cu has its design) and launch_fwd_tiles,
// the one launch that K1, K2's stats pass and K3's prefill share, in a
// translation unit of their own: _build.py compiles it once and links it
// into each of their libraries.

#include "attention_fwd_tiles.cuh"

namespace merlot {


// DV: V's and ctx's head dim (D's but for MLA). CAUSAL (Sq = Sk): the q
// tiles run last first (the longest rows start first) and each visits its
// key tiles up to its own, the diagonal one masked by causal_tile.
template <int D, int VAR, int DV = D, bool CAUSAL = false>
__global__ void __launch_bounds__(kWgThreads, kFwdMinBlocks)
attention_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const FwdArgs a) {
  using namespace sm90;
  constexpr uint32_t kTile = tile_bytes<D>();
  constexpr uint32_t kStage = kTile + tile_bytes<DV>();  // a K tile and its V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_q = aligned_smem(smem_raw);
  uint8_t* s_kv = s_q + kTile;               // stage st: K at st kStage, then V
  float* s_cs = reinterpret_cast<float*>(s_kv + kFwdStages * kStage);  // [warps][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_cs + 4 * kKvTile);  // stages, Q
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(bar + kFwdStages + 1);  // [n_kt][threads]

  const int qt = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTileRows;
  const int tid = threadIdx.x, t = tid % 4;
  const int Sq = a.Sq, Sk = a.Sk;
  const int n_kt = CAUSAL ? qt + 1 : (Sk + kKvTile - 1) / kKvTile;
  // passes: 1 the row max and sum (the probe's variants skip it), 2 the
  // probs, colsum and ctx
  const int p0 = VAR == kProd ? 1 : 2;
  const int p1 = a.stats_only ? 1 : 2;
  const int n_loads = (p1 - p0 + 1) * n_kt;

  // load i of the block's stream: key tile i % n_kt, with V in pass 2
  auto fetch = [&](int i) {
    if (i >= n_loads) return;
    const int st = i % kFwdStages, k0 = (i % n_kt) * kKvTile;
    const bool with_v = p0 + i / n_kt == 2;
    uint8_t* dst = s_kv + st * kStage;
    mbar_expect_tx(&bar[st], with_v ? kStage : kTile);
    tma_tile<D>(dst, &tm_k, &bar[st], a.k_col0 + h * D, k0, b);
    if (with_v) tma_tile<DV>(dst + kTile, &tm_v, &bar[st], a.v_col0 + h * DV, k0, b);
  };
  if (tid == 0) {
    for (int i = 0; i <= kFwdStages; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[kFwdStages], kTile);
    tma_tile<D>(s_q, &tm_q, &bar[kFwdStages], h * D, q0, b);
    for (int i = 0; i < kFwdStages; ++i) fetch(i);
  }

  int qrow[2];
  bool real[2];
  const float* mrow[2];
  for (int half = 0; half < 2; ++half) {
    qrow[half] = q0 + acc_row(tid, half);
    real[half] = qrow[half] < Sq;
    mrow[half] = a.mask != nullptr && real[half]
                     ? a.mask + b * a.mask_bs + (size_t)qrow[half] * Sk
                     : nullptr;
  }
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, rcp[2] = {1.f, 1.f};
  if (VAR == kNoMax) mx[0] = mx[1] = 0.f, sum[0] = sum[1] = 1.f;
  float* part = a.colsum_part == nullptr
                    ? nullptr
                    : a.colsum_part + (((size_t)b * a.H + h) * gridDim.x + qt) * Sk;

  mbar_wait(&bar[kFwdStages], 0);
  // the first pass reads the mask from memory and keeps it as bits; the
  // second reads the bits when the block's mask is all 0 and 1
  bool binary = false, other = false;
  int i = 0;
  if (p0 == 1) {
    // pass 1: the running max, and the sum of exp(s - max) rescaled when
    // the max grows (exp(-inf) = 0: keys past Sk add nothing). Its own loop,
    // so that ctx's accumulator is not live here
    for (int kt = 0; kt < n_kt; ++kt, ++i) {
      const int st = i % kFwdStages;
      uint32_t* bits = a.mask != nullptr ? &s_bits[kt * kWgThreads + tid] : nullptr;
      float s[32];
      mbar_wait(&bar[st], (i / kFwdStages) & 1);
      score_tile<D>(s, s_q, s_kv + st * kStage);
      mask_any_tile(s, mrow, kt * kKvTile, Sk, a.scale, a.sm_bf16, bits, false, other);
      if (CAUSAL && kt == qt) causal_tile(s, qrow, kt * kKvTile, Sk, a.sm_bf16);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float m = mx[half];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          m = fmaxf(m, fmaxf(s[4 * j + 2 * half], s[4 * j + 2 * half + 1]));
        if (m != mx[half]) {
          sum[half] *= exp_sfu(mx[half] - m);
          mx[half] = m;
        }
        if (mx[half] != -INFINITY) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            sum[half] += exp_sfu(s[4 * j + 2 * half] - mx[half]) +
                         exp_sfu(s[4 * j + 2 * half + 1] - mx[half]);
        }
      }
      // every warp is done with this stage: refill it
      __syncthreads();
      if (tid == 0) fetch(i + kFwdStages);
    }
    binary = !__syncthreads_or(other);
    // the row's four threads: their sums rescaled to the row's max
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float m = quad_max(mx[half]);
      const float part_sum = mx[half] == -INFINITY ? 0.f
                             : mx[half] == m      ? sum[half]
                                                  : sum[half] * exp_sfu(mx[half] - m);
      mx[half] = m;
      sum[half] = quad_sum(part_sum);
      rcp[half] = __frcp_rn(sum[half]);
    }
    if (a.stats != nullptr && t == 0) {
      const size_t n = (size_t)gridDim.z * a.H * Sq, r0 = ((size_t)b * a.H + h) * Sq;
      for (int half = 0; half < 2; ++half)
        if (real[half]) {
          a.stats[r0 + qrow[half]] = mx[half];
          a.stats[n + r0 + qrow[half]] = sum[half];
        }
    }
    if (a.stats_only) return;
  }

  // pass 2: p in the softmax dtype (0 past Sk), the colsum partials, and
  // ctx += round_bf16(p) . V
  float o[DV / 2];
  zero(o);
  for (int kt = 0; kt < n_kt; ++kt, ++i) {
    const int st = i % kFwdStages, k0 = kt * kKvTile;
    const uint8_t* s_k = s_kv + st * kStage;
    // the variants read the mask here for the first time
    uint32_t* bits = a.mask != nullptr && (p0 == 2 || binary)
                         ? &s_bits[kt * kWgThreads + tid]
                         : nullptr;
    float s[32];
    mbar_wait(&bar[st], (i / kFwdStages) & 1);
    score_tile<D>(s, s_q, s_k);
    mask_any_tile(s, mrow, k0, Sk, a.scale, a.sm_bf16, bits, p0 == 1 && binary, other);
    if (CAUSAL && kt == qt) causal_tile(s, qrow, k0, Sk, a.sm_bf16);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int half = (x / 2) % 2;
      if (VAR == kMmOnly)
        s[x] = s[x] == -INFINITY ? 0.f : round_as<bf16>(s[x]);
      else
        s[x] = prob_rcp(s[x], mx[half], sum[half], rcp[half], a.sm_bf16);
    }
    if (part != nullptr) {
      // this tile's column sums over the real rows, in a fixed order:
      // the thread's two rows, the warp's 8 row pairs, the warps
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float c = (real[0] ? s[4 * j + e] : 0.f) + (real[1] ? s[4 * j + 2 + e] : 0.f);
          c += __shfl_xor_sync(0xffffffffu, c, 4);
          c += __shfl_xor_sync(0xffffffffu, c, 8);
          c += __shfl_xor_sync(0xffffffffu, c, 16);
          if (tid % 32 < 4) s_cs[(tid / 32) * kKvTile + acc_col(tid, j, e)] = c;
        }
      __syncthreads();
      if (tid < kKvTile && k0 + tid < Sk) {
        float c = s_cs[tid];
        for (int w = 1; w < 4; ++w) c += s_cs[w * kKvTile + tid];
        part[k0 + tid] = c;
      }
    }
    uint32_t pa[4][4];
    a_frags(pa, s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<DV>::template rs<1>(o, pa[kk], desc_mnmajor<DV>(s_k + kTile, kk));
    wg_commit();
    wg_wait_all();
    reg_fence(o);
    // every warp is done with this stage: refill it
    __syncthreads();
    if (tid == 0) fetch(i + kFwdStages);
  }

  const size_t hd = (size_t)a.H * DV;
  bf16* ob = a.out + (size_t)b * Sq * hd + (size_t)h * DV;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!real[half]) continue;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<uint32_t*>(ob + (size_t)qrow[half] * hd + acc_col(tid, j, 0)) =
          pack_bf16(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
  }
}

template <int D, int VAR, int DV = D, bool CAUSAL = false>
cudaError_t launch_fwd_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                             const CUtensorMap& tv, const FwdArgs& a, int B,
                             cudaStream_t st) {
  const dim3 grid((a.Sq + sm90::kTileRows - 1) / sm90::kTileRows, a.H, B);
  // MLA's launches hold the mask bits only with a mask
  const bool bits = DV == D || a.mask != nullptr;
  return launch(attention_fwd_wgmma<D, VAR, DV, CAUSAL>, grid, kWgThreads,
                fwd_smem<D, DV>(a.Sk, bits), st, tq, tk, tv, a);
}

cudaError_t launch_fwd_tiles(const void* q, const void* k, const void* v,
                             int v_col0, const float* mask, void* out,
                             float* colsum_part, float* stats, uint8_t* tile_class,
                             int B, int Sq, int Sk, int H, int D, int kv_ld,
                             size_t mask_bs, bool is_bf16, bool sm_bf16, float scale,
                             cudaStream_t st, int variant,
                             bool stats_only, int Dv, bool causal) {
  if (Dv == 0) Dv = D;
  if (!is_bf16 && (Dv != D || causal)) return cudaErrorInvalidValue;
  if (!is_bf16) {
    if (variant != kProd || sm_bf16 || D > kMaxHeadDim) return cudaErrorInvalidValue;
    const f32::FwdArgs a{static_cast<const float*>(q),
                         static_cast<const float*>(k),
                         static_cast<const float*>(v) + v_col0,
                         mask,
                         nullptr,
                         static_cast<float*>(out),
                         colsum_part,
                         stats,
                         Sq,
                         Sk,
                         H,
                         D,
                         kv_ld,
                         mask_bs,
                         scale,
                         stats_only};
    return f32::launch_fwd_f32(a, tile_class, B, st);
  }
  if (Dv != D || causal) {
    // MLA's heads: separate q, k [B, S, H*D] and v [B, Sk, H*Dv]
    if (D != kMlaQkDim || Dv != kMlaVDim || variant != kProd || colsum_part != nullptr ||
        kv_ld != H * D || v_col0 != 0 || (causal && Sq != Sk))
      return cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv;
    cudaError_t err = sm90::make_tile_map(&tq, q, B, Sq, H * D, D);
    if (err == cudaSuccess) err = sm90::make_tile_map(&tk, k, B, Sk, kv_ld, D);
    if (err == cudaSuccess) err = sm90::make_tile_map(&tv, v, B, Sk, H * Dv, Dv);
    if (err != cudaSuccess) return err;
    const FwdArgs a{mask, static_cast<bf16*>(out), nullptr, stats, Sq, Sk, H, 0, 0,
                    mask_bs, scale, sm_bf16, stats_only};
    return causal ? launch_fwd_wgmma<kMlaQkDim, kProd, kMlaVDim, true>(tq, tk, tv, a, B, st)
                  : launch_fwd_wgmma<kMlaQkDim, kProd, kMlaVDim, false>(tq, tk, tv, a, B, st);
  }
  if (D % 16 != 0 || D > kMaxHeadDim) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::make_tile_map(&tq, q, B, Sq, H * D, D);
  if (err == cudaSuccess) err = sm90::make_tile_map(&tk, k, B, Sk, kv_ld, D);
  if (err == cudaSuccess) err = sm90::make_tile_map(&tv, v, B, Sk, kv_ld, D);
  if (err != cudaSuccess) return err;
  const FwdArgs a{mask,   static_cast<bf16*>(out), colsum_part, stats, Sq, Sk, H, 0,
                  v_col0, mask_bs, scale, sm_bf16, stats_only};
  if (variant != kProd) {
    if (D != 64) return cudaErrorInvalidValue;
    switch (variant) {
      case kMmOnly: return launch_fwd_wgmma<64, kMmOnly>(tq, tk, tv, a, B, st);
      case kNoMax: return launch_fwd_wgmma<64, kNoMax>(tq, tk, tv, a, B, st);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 16: return launch_fwd_wgmma<16, kProd>(tq, tk, tv, a, B, st);
    case 32: return launch_fwd_wgmma<32, kProd>(tq, tk, tv, a, B, st);
    case 48: return launch_fwd_wgmma<48, kProd>(tq, tk, tv, a, B, st);
    case 64: return launch_fwd_wgmma<64, kProd>(tq, tk, tv, a, B, st);
    case 80: return launch_fwd_wgmma<80, kProd>(tq, tk, tv, a, B, st);
    case 96: return launch_fwd_wgmma<96, kProd>(tq, tk, tv, a, B, st);
    case 112: return launch_fwd_wgmma<112, kProd>(tq, tk, tv, a, B, st);
    default: return launch_fwd_wgmma<128, kProd>(tq, tk, tv, a, B, st);
  }
}

}  // namespace merlot
